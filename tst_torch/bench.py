"""Throughput bench of the port: the counterpart of ``bench.py``.

    python -m tst_torch.bench [--platform gpu|cpu]

Prints ONE JSON line on stdout, the reference's contract:

  {"metric": "blind_sft_samples_per_sec_per_chip", "value": N,
   "unit": "samples/s/chip", "vs_baseline": R, ...}

and everything else on stderr. ``value`` is the fold-parallel blind-SFT rate
(all k folds in one step), the better of unpacked and packed rows;
``vs_baseline`` is that rate over the fold-sequential baseline (k one-fold
steps a step: the reference's per-fold jobs on one card). The legs are the
reference's, leg for leg and key for key:

  * Qwen2.5-0.5B, LoRA r16 on q/k/v/o, k=5 folds x 4 rows x 512 tokens,
    ``remat="dots"``: fold-parallel, packed (3 rows of 1024 a fold, samples
    counted by segment) and fold-sequential;
  * Llama-3-8B on an int8 base: k=2 x 2 rows (``remat="dots"``), k=5 x 1 row
    (``"attn"``), and both packed, one row of 1024 a fold;
  * Llama-3-8B on an int4 base: greedy decode of 32 rows, the step rate by
    the difference of 16 and 4 new tokens;
  * Qwen2.5-0.5B at 16,384 and 32,768 tokens, k=2 x 1 row, ``remat="flash"``;
  * Qwen2.5-0.5B greedy decode of 32 rows, 16 new tokens.

On the card (``gpu``, the default) every leg runs, through the CUDA
kernels; without a CUDA device ``gpu`` raises. ``cpu`` runs the three
first legs at the ``small`` spec on the plain path, as the reference does
off the TPU. A leg that raises is reported on stderr and left out of the
record; the headline never depends on it.

``TST_BENCH_STEPS`` / ``TST_BENCH_WARMUP`` set the 0.5B legs' timed and
untimed steps (default 12 and 3), as in the reference; the 8B, long and
decode legs keep their fixed counts.

Departures from the reference:

  * no ``xla_programs_*`` keys: an eager step is no XLA program;
  * ``n_chips`` is the number of cards the bench ran on (one), not every
    card the machine shows: the step runs on one;
  * ``compile_s`` is the first step's wall; ``compile_cache_hit`` says
    whether the kernel library was already built (no ``nvcc`` ran), the
    counterpart of the persistent XLA cache; ``hbm_gb`` is the peak of
    ``torch.cuda.max_memory_allocated`` over the leg (None on the CPU);
  * ``mfu`` is against the H100's dense bf16 peak;
  * the decode legs take no ``layer_loop`` (a TPU scan/unroll knob).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from tst_torch.runtime.device import PLATFORMS, select_device

#: NVIDIA H100 SXM, dense bf16 (the data sheet): the MFU's denominator
H100_PEAK_BF16_FLOPS = 989e12

#: the workload (bench.py:84-102): the north-star fold count, rows a fold
#: (~20 rows a step), tokens a row; the synthetic MCQ benchmark
K, BATCH, SEQ = 5, 4, 512
N_ROWS, BIAS_FRACTION, EPOCHS = 256, 0.5, 50
#: packed rows: ~3 samples a row of 1024, 3 rows a fold (bench.py:173)
PACK_LEN, PACK_BATCH = 2 * SEQ, 3
LORA_RANK, LORA_ALPHA, LR = 16, 32.0, 1e-4
#: the 0.5B legs' timed and untimed steps when the environment sets none
STEPS, WARMUP = 12, 3
#: the fixed legs: untimed steps (the first one included), then timed ones
FIXED_WARM = 2
L8_K2_TIMED, L8_K5_TIMED, L8_PACKED_TIMED = 6, 5, 6
LONG_TIMED, LONG32_TIMED = 4, 3
LONG_LEN, LONG32_LEN = 16384, 32768
#: the decode legs: rows, new tokens of the full and the short call, and the
#: timed calls of each (after one untimed)
DECODE_ROWS, DECODE_NEW, DECODE_SHORT, DECODE_TIMED = 32, 16, 4, 3
#: the 8B packed legs: folds and remat mode, and the record key of each
L8_PACKED = ((2, "dots", "packed_samples_per_s"), (5, "attn", "k5_packed_samples_per_s"))


def bench_steps(environ=os.environ) -> tuple:
    """(STEPS, WARMUP) as the reference reads them: each at least 1."""
    return (max(1, int(environ.get("TST_BENCH_STEPS", STEPS))),
            max(1, int(environ.get("TST_BENCH_WARMUP", WARMUP))))


def bench_model(on_card: bool) -> str:
    """The 0.5B legs' model: Qwen2.5-0.5B's geometry on the card, as the
    reference on the TPU; elsewhere ``small``."""
    return "qwen2.5-0.5b" if on_card else "small"


def real_samples(n_segs: np.ndarray, idx: np.ndarray) -> int:
    """The samples (segments) in packed batches ``idx`` [steps, k, B] of
    per-fold rows with ``n_segs`` [k, Np]."""
    idx = np.asarray(idx)
    return int(n_segs[np.arange(idx.shape[1])[None, :, None], idx].sum())


@dataclasses.dataclass
class Workload:
    """The host arrays every leg draws from (bench.py:84-107, 164-198,
    275-276, 320, 347-350, 450)."""

    spec_name: str
    ds: Any
    tb: Any  # TokenBatch at SEQ
    fold_id: np.ndarray  # [N] the K-fold assignment
    t_max: int
    batches: np.ndarray  # [steps + warmup + 1, K, BATCH]
    pack: Any  # FoldPacked at PACK_LEN
    pbatches: np.ndarray  # [steps + warmup + 1, K, PACK_BATCH]
    n_real: int  # samples in the packed leg's timed steps
    fid2: np.ndarray  # the 2-fold assignment of the 8B k=2 legs
    b8: np.ndarray  # the 8B k=2 batches [.., 2, 2]
    b5: np.ndarray  # the 8B k=5 batches [.., 5, 1]
    packed8: Dict[int, tuple]  # k → (FoldPacked, batches [.., k, 1]) of the 8B packed legs
    blong: np.ndarray  # the long legs' batches [.., 2, 1]


def bench_workload(on_card: bool, steps: int = STEPS, warmup: int = WARMUP) -> Workload:
    """The reference's workload from its calls, with :func:`bench_model`'s
    model."""
    from tst_torch.data.folds import kfold_assign
    from tst_torch.data.packing import make_packed_fold_batches, pack_fold_datasets
    from tst_torch.data.synthetic import make_synthetic_mcq
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.train.sft import make_fold_batches

    ds = make_synthetic_mcq(n=N_ROWS, bias_fraction=BIAS_FRACTION, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=SEQ)
    fold_id = kfold_assign(ds, K, seed=0)
    n_batches = steps + warmup + 1
    batches = make_fold_batches(fold_id, K, BATCH, epochs=EPOCHS, seed=0)[:n_batches]
    pack = pack_fold_datasets(tb, fold_id, K, PACK_LEN)
    pbatches = make_packed_fold_batches(pack.n_rows, PACK_BATCH, epochs=EPOCHS,
                                        seed=0)[:n_batches]
    fid2 = kfold_assign(ds, 2, seed=0)
    packed8 = {}
    for kk, _, _ in L8_PACKED:
        fp8 = pack_fold_datasets(tb, fid2 if kk == 2 else kfold_assign(ds, kk, seed=0), kk,
                                 PACK_LEN)
        packed8[kk] = (fp8, make_packed_fold_batches(fp8.n_rows, 1, epochs=20, seed=0))
    return Workload(
        spec_name=bench_model(on_card), ds=ds, tb=tb, fold_id=fold_id,
        t_max=int(np.max(tb.lengths - tb.answer_pos - 1)),
        batches=batches, pack=pack, pbatches=pbatches,
        n_real=real_samples(pack.n_segs, pbatches[warmup: warmup + steps]),
        fid2=fid2, b8=make_fold_batches(fid2, 2, 2, epochs=10, seed=0),
        b5=make_fold_batches(fold_id, 5, 1, epochs=5, seed=0), packed8=packed8,
        blong=make_fold_batches(fold_id, 2, 1, epochs=10, seed=0))


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


def _to(device: torch.device, *arrays) -> list:
    return [torch.from_numpy(np.asarray(a)).to(device) for a in arrays]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _kernels_built() -> bool:
    """The kernel library of these sources is already on disk: no nvcc runs."""
    from tst_torch.kernels import _build

    return _build.library_path().exists()


def _steps(trainer, params, state, arrays, batches, ts, segs=None):
    """``trainer.step`` on ``batches[t]`` for t in ``ts``, then a
    synchronize → (state, seconds)."""
    lora, opt = state
    t0 = time.perf_counter()
    for t in ts:
        lora, opt, _ = trainer.step(params, lora, opt, *arrays, batches[t], segs)
    _sync(arrays[0].device)
    return (lora, opt), time.perf_counter() - t0


def bench_trainer(trainer, params, arrays: Sequence[torch.Tensor], batches: np.ndarray,
                  steps: int, warmup: int, samples: int, segs=None) -> Dict[str, Any]:
    """One leg (bench.py:109-156): the first step's wall, ``warmup - 1``
    more untimed steps, then ``steps`` timed ones, each window ending in a
    synchronize; ``samples`` are what the timed steps train on. The rate,
    the step's ms and model FLOPs (tst_torch.aux.flops), on the card its MFU
    against the H100's bf16 peak and the leg's peak device memory."""
    from tst_torch.aux.flops import train_step_flops

    device = arrays[0].device
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    cache_hit = _kernels_built() if on_card else None
    state = trainer.init_state(_generator(device, 1))
    state, compile_s = _steps(trainer, params, state, arrays, batches, [0], segs)
    state, _ = _steps(trainer, params, state, arrays, batches, range(1, warmup), segs)
    state, wall = _steps(trainer, params, state, arrays, batches,
                         range(warmup, warmup + steps), segs)
    dt = wall / steps
    flops = train_step_flops(trainer.spec, trainer.lora_spec,
                             n_rows=int(batches.shape[1] * batches.shape[2]),
                             seq=int(arrays[0].shape[-1]), t_max=trainer.t_max or 0,
                             remat=trainer.remat)["model_flops"]
    return {"samples_per_s": samples / wall, "step_ms": dt * 1e3, "compile_s": compile_s,
            "compile_cache_hit": cache_hit, "flops_per_step": flops,
            "mfu": flops / dt / H100_PEAK_BF16_FLOPS if on_card else None,
            "hbm_gb": (round(torch.cuda.max_memory_allocated(device) / 1e9, 3)
                       if on_card else None)}


def fold_sequential(trainer, params, arrays, batches: np.ndarray, steps: int,
                    warmup: int) -> tuple:
    """The baseline (bench.py:224-253): K one-fold states, each stepped on
    its fold's rows in turn → (samples/s, the first step's wall)."""
    device = arrays[0].device
    states = [trainer.init_state(_generator(device, 2 + f)) for f in range(K)]
    states[0], first_s = _steps(trainer, params, states[0], arrays, batches[:, 0:1], [0])

    def sweep(ts):
        t0 = time.perf_counter()
        for t in ts:
            for f in range(K):
                lora, opt, _ = trainer.step(params, *states[f], *arrays, batches[t, f:f + 1])
                states[f] = (lora, opt)
        _sync(device)
        return time.perf_counter() - t0

    sweep(range(1, warmup))
    return steps * K * BATCH / sweep(range(warmup, warmup + steps)), first_s


def decode_rates(params, spec, tokens: torch.Tensor, pos: torch.Tensor) -> dict:
    """Greedy decode of DECODE_ROWS prompts through the kernels (bench.py:
    384-433, 503-551): DECODE_TIMED calls after one untimed, at DECODE_NEW
    and at DECODE_SHORT new tokens → tokens/s of the full call and the
    steps' own rate by the difference of the two (None where the full call
    is not the slower)."""
    from tst_torch.models.decode import greedy_decode

    rows = torch.arange(DECODE_ROWS, device=tokens.device) % tokens.shape[0]
    toks, plen = tokens[rows], pos[rows] + 1

    def seconds(max_new):
        greedy_decode(params, toks, plen, max_new, spec, use_pallas=True)
        _sync(tokens.device)
        t0 = time.perf_counter()
        for _ in range(DECODE_TIMED):
            greedy_decode(params, toks, plen, max_new, spec, use_pallas=True)
        _sync(tokens.device)
        return (time.perf_counter() - t0) / DECODE_TIMED

    full, short = seconds(DECODE_NEW), seconds(DECODE_SHORT)
    out = {"tokens_per_s": round(DECODE_ROWS * DECODE_NEW / full, 1), "batch": DECODE_ROWS,
           "max_new": DECODE_NEW}
    if full > short:
        out["step_tokens_per_s"] = round(
            DECODE_ROWS * (DECODE_NEW - DECODE_SHORT) / (full - short), 1)
    return out


def _leg(name: str, fn: Callable[[], Any]) -> Any:
    """``fn()``; a leg that raises is reported on stderr and gives None."""
    t0 = time.perf_counter()
    try:
        out = fn()
    except Exception as e:  # a leg must never sink the headline
        traceback.print_exc(file=sys.stderr)
        print(f"{name} skipped: {type(e).__name__}: {e}", file=sys.stderr)
        return None
    print(f"[bench] {name}: {time.perf_counter() - t0:.1f} s {out}", file=sys.stderr,
          flush=True)
    return out


def _free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def llama8b_int8_legs(w: Workload, arrays, device) -> dict:
    """The 8B train legs on one int8 base (bench.py:255-382): k=2 under
    "dots", k=5 under "attn", and both packed; the base freed after."""
    from tst_torch.models.decoder import init_params
    from tst_torch.models.lora import LoraSpec
    from tst_torch.models.quant import quantize_params, quantized_bytes
    from tst_torch.models.spec import spec_by_name
    from tst_torch.train.sft import FoldTrainer

    spec8 = spec_by_name("llama3-8b")
    params8 = quantize_params(init_params(_generator(device, 0), spec8), bits=8)
    try:
        lspec8 = LoraSpec(rank=LORA_RANK, alpha=LORA_ALPHA, dtype=spec8.dtype)

        def trainer(kk, remat, **kw):
            return FoldTrainer(spec8, lspec8, k=kk, lr=LR, total_steps=10, use_pallas=True,
                               remat=remat, t_max=w.t_max, **kw)

        k2 = bench_trainer(trainer(2, "dots"), params8, arrays, w.b8, L8_K2_TIMED, FIXED_WARM,
                           L8_K2_TIMED * 2 * 2)
        out = {"samples_per_s": k2["samples_per_s"], "mfu": k2["mfu"],
               "base_hbm_gb": round(quantized_bytes(params8) / 1e9, 2),
               "hbm_gb": k2["hbm_gb"], "compile_s": k2["compile_s"]}
        _free(device)
        k5 = _leg("8B k=5 leg", lambda: bench_trainer(
            trainer(5, "attn"), params8, arrays, w.b5, L8_K5_TIMED, FIXED_WARM,
            L8_K5_TIMED * 5))
        if k5 is not None:
            out["k5_samples_per_s"] = k5["samples_per_s"]
        _free(device)

        def packed_legs():
            for kk, remat, key in L8_PACKED:
                fp8, pb8 = w.packed8[kk]
                parrays = _to(device, fp8.tokens, fp8.loss_mask, fp8.answer_pos)
                (psegs,) = _to(device, fp8.seg_starts)
                leg = bench_trainer(
                    trainer(kk, remat, packed=True), params8, parrays, pb8, L8_PACKED_TIMED,
                    FIXED_WARM,
                    real_samples(fp8.n_segs, pb8[FIXED_WARM: FIXED_WARM + L8_PACKED_TIMED]),
                    segs=psegs)
                out[key] = leg["samples_per_s"]
                del parrays, psegs
                _free(device)
            return {key: out[key] for _, _, key in L8_PACKED}

        _leg("8B packed legs", packed_legs)
        return out
    finally:
        del params8
        _free(device)


def llama8b_int4_decode(w: Workload, arrays, device) -> Optional[dict]:
    """The 8B int4 greedy-decode leg (bench.py:384-433): its own base."""
    from tst_torch.models.decoder import init_params
    from tst_torch.models.quant import quantize_params
    from tst_torch.models.spec import spec_by_name

    spec8 = spec_by_name("llama3-8b")
    params4 = quantize_params(init_params(_generator(device, 0), spec8), bits=4)
    try:
        rates = decode_rates(params4, spec8, arrays[0], arrays[2])
        if "step_tokens_per_s" not in rates:
            return None
        return {"step_tokens_per_s": rates["step_tokens_per_s"], "batch": DECODE_ROWS}
    finally:
        del params4
        _free(device)


def long_leg(w: Workload, params, spec, lspec, device, seq_len: int, timed: int) -> dict:
    """k=2 x 1 row of ``seq_len`` tokens under ``remat="flash"`` (bench.py:
    435-501) → tokens/s."""
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.train.sft import FoldTrainer

    tbl = tokenize_dataset(w.ds, ByteTokenizer(), max_len=seq_len)
    t_long = int(np.max(tbl.lengths - tbl.answer_pos - 1))
    trainer = FoldTrainer(spec, lspec, k=2, lr=LR, total_steps=8, use_pallas=True,
                          remat="flash", t_max=t_long)
    larrays = _to(device, tbl.tokens, tbl.loss_mask, tbl.answer_pos)
    try:
        leg = bench_trainer(trainer, params, larrays, w.blong, timed, FIXED_WARM, timed * 2)
    finally:
        del larrays
        _free(device)
    return {"tokens_per_s": round(2 * 1 * seq_len / (leg["step_ms"] / 1e3), 1),
            "seq_len": seq_len}


def bench_record(spec_name: str, backend: str, par: dict, packed: Optional[dict],
                 sps_sequential: float, seq_compile_s: float, llama8b: Optional[dict] = None,
                 llama8b_decode: Optional[dict] = None, longseq: Optional[dict] = None,
                 longseq32: Optional[dict] = None, decode: Optional[dict] = None
                 ) -> Dict[str, Any]:
    """The reference's record (bench.py:550-632) from the legs' results,
    without its ``xla_programs_*`` keys; every rate is the one card's the
    bench ran on (``n_chips`` 1)."""
    best_sps, headline_cfg = par["samples_per_s"], "unpacked"
    if packed is not None and packed["samples_per_s"] > best_sps:
        best_sps, headline_cfg = packed["samples_per_s"], "packed"
    out = {
        "metric": "blind_sft_samples_per_sec_per_chip",
        "value": round(best_sps, 3),
        "unit": "samples/s/chip",
        "vs_baseline": round(best_sps / sps_sequential, 3),
        "baseline": "fold-sequential same-chip (reference-style per-fold jobs)",
        "headline_config": headline_cfg,
        "unpacked_samples_per_sec_per_chip": round(par["samples_per_s"], 3),
        "model": spec_name,
        "k": K, "batch_per_fold": BATCH, "seq_len": SEQ,
        "backend": backend, "n_chips": 1,
        "fold_sequential_samples_per_sec_per_chip": round(sps_sequential, 3),
        "compile_s_fold_parallel": round(par["compile_s"], 1),
        "compile_cache_hit_fold_parallel": par["compile_cache_hit"],
        "compile_s_single_fold": round(seq_compile_s, 1),
        "step_hbm_gb": par["hbm_gb"],
    }
    # one fold fine-tune at the config-2 shape: 3 epochs over its (k-1)/k
    # train split of n=512; the fold-parallel step runs k of them at once
    samples_per_finetune = 3 * int(512 * (K - 1) / K)
    out["fold_finetunes_per_hour_per_chip"] = round(best_sps * 3600.0 / samples_per_finetune, 1)
    if par["mfu"]:
        out["mfu"] = round(par["mfu"], 3)
        out["tflops_per_s"] = round(par["flops_per_step"] / (par["step_ms"] / 1e3) / 1e12, 1)
    if packed is not None:
        out["packed_samples_per_sec_per_chip"] = round(packed["samples_per_s"], 3)
        out["pack_len"] = packed["pack_len"]
        out["pack_fill_fraction"] = round(packed["fill"], 3)
        out["pack_batch_rows_per_fold"] = packed["batch_rows"]
        if packed["mfu"]:
            out["packed_mfu"] = round(packed["mfu"], 3)
    if llama8b is not None:
        out["llama3_8b_int8_samples_per_sec_per_chip"] = round(llama8b["samples_per_s"], 3)
        if llama8b["mfu"]:
            out["llama3_8b_mfu"] = round(llama8b["mfu"], 3)
        out["llama3_8b_base_hbm_gb"] = llama8b["base_hbm_gb"]
        out["llama3_8b_step_hbm_gb"] = llama8b["hbm_gb"]
        for key, name in (("k5_samples_per_s", "k5_fold_parallel"),
                          ("packed_samples_per_s", "packed"),
                          ("k5_packed_samples_per_s", "k5_packed")):
            if key in llama8b:
                out[f"llama3_8b_{name}_samples_per_sec_per_chip"] = round(llama8b[key], 3)
    if longseq is not None:
        out["longseq_tokens_per_s"] = longseq["tokens_per_s"]
        out["longseq_len"] = longseq["seq_len"]
    if longseq32 is not None:
        out["longseq_32k_tokens_per_s"] = longseq32["tokens_per_s"]
    if decode is not None:
        out["decode_tokens_per_s"] = decode["tokens_per_s"]
        out["decode_batch"] = decode["batch"]
        if "step_tokens_per_s" in decode:
            out["decode_step_tokens_per_s"] = decode["step_tokens_per_s"]
    if llama8b_decode is not None:
        out["llama3_8b_int4_decode_step_tokens_per_s"] = llama8b_decode["step_tokens_per_s"]
    return out


def run_bench(platform: str = "gpu") -> Dict[str, Any]:
    """Every leg on ``platform`` → the record (:func:`bench_record`)."""
    from tst_torch.models.decoder import init_params
    from tst_torch.models.lora import LoraSpec
    from tst_torch.models.spec import spec_by_name
    from tst_torch.train.sft import FoldTrainer

    device = select_device(platform)
    on_card = device.type == "cuda"
    steps, warmup = bench_steps()
    w = bench_workload(on_card, steps, warmup)
    spec = spec_by_name(w.spec_name)
    lspec = LoraSpec(rank=LORA_RANK, alpha=LORA_ALPHA, dtype=spec.dtype)
    params = init_params(_generator(device, 0), spec)
    arrays = _to(device, w.tb.tokens, w.tb.loss_mask, w.tb.answer_pos)

    def trainer(k, **kw):
        return FoldTrainer(spec, lspec, k=k, lr=LR, total_steps=steps + warmup,
                           use_pallas=on_card, remat="dots" if on_card else False,
                           t_max=w.t_max, **kw)

    # fold-parallel: one step trains all k folds (the headline: not caught)
    par = bench_trainer(trainer(K), params, arrays, w.batches, steps, warmup,
                        steps * K * BATCH)
    print(f"[bench] fold-parallel leg: {par}", file=sys.stderr, flush=True)

    # packed fold-parallel: the same samples, ~3 to a row of PACK_LEN
    def packed_leg():
        parrays = _to(device, w.pack.tokens, w.pack.loss_mask, w.pack.answer_pos)
        (psegs,) = _to(device, w.pack.seg_starts)
        leg = bench_trainer(trainer(K, packed=True), params, parrays, w.pbatches, steps,
                            warmup, w.n_real, segs=psegs)
        return {**leg, "fill": w.pack.fill_fraction, "pack_len": PACK_LEN,
                "batch_rows": PACK_BATCH}

    packed = _leg("packed leg", packed_leg)
    _free(device)

    # fold-sequential baseline: K one-fold steps a step
    sps_sequential, seq_compile_s = fold_sequential(trainer(1), params, arrays, w.batches,
                                                    steps, warmup)
    print(f"[bench] fold-sequential leg: {sps_sequential:.3f} samples/s", file=sys.stderr)
    _free(device)

    llama8b = llama8b_decode = longseq = longseq32 = decode = None
    if on_card:
        llama8b = _leg("8B leg", lambda: llama8b_int8_legs(w, arrays, device))
        llama8b_decode = _leg("8B int4 decode leg",
                              lambda: llama8b_int4_decode(w, arrays, device))
        longseq = _leg("long-seq leg", lambda: long_leg(w, params, spec, lspec, device,
                                                        LONG_LEN, LONG_TIMED))
        longseq32 = _leg("32k leg", lambda: long_leg(w, params, spec, lspec, device,
                                                     LONG32_LEN, LONG32_TIMED))
        decode = _leg("decode leg", lambda: decode_rates(params, spec, arrays[0], arrays[2]))
    return bench_record(spec.name, "cuda" if on_card else "cpu", par, packed, sps_sequential,
                        seq_compile_s, llama8b, llama8b_decode, longseq, longseq32, decode)


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--platform", choices=PLATFORMS, default="gpu")
    args = parser.parse_args(argv)
    print(json.dumps(run_bench(args.platform)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
