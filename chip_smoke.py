#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tst_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                  # every phase below
    python3 chip_smoke.py --only rank      # phases 1-2, then the attention kernels vs the library
    python3 chip_smoke.py --only mlp-int4  # phases 1-2, 11-12 (K3, K4), the int4 decode
                                           # and fused train steps of phases 13-14

Every step compared with the plain path (phases 7, 10, 14) holds its
per-fold losses within 1e-3 of the plain loss, relative, and its LoRA
gradients at cosine >= 0.99.

Phases, each printing one line; any failure raises and exits non-zero:

  1. device  — a CUDA device is present; its name and power limit;
  2. build   — nvcc builds every kernel from tst_torch/csrc (sm_90a); each
               kernel's registers and spill bytes; the count of wgmma (HGMMA)
               instructions in the SASS (cuobjdump) of each of the 12
               attention kernels (forward, dK/dV, dQ at D=64 and 128, plain
               and segmented) and of the two K4 kernels (gate-up, down),
               which must not be 0;
  3. kernel  — the flash-attention forward kernel against its plain PyTorch
               version on the card at the slice's shape, Llama-3-8B heads, a
               128-token case and one tile (S=64) at both head dims;
               bit-equal on a second call; bad shapes raise; median kernel
               and plain times;
  4. slice   — ``python -m tst_torch eval-blind`` (Qwen2.5-0.5B at full
               width, random weights from the seed, bf16, the synthetic MCQ
               benchmark, n=512) through the CLI entry point; the kernel's
               launch count must be 24 layers x 16 chunks; the same tokens
               and weights scored through the plain attention must give the
               same letter probabilities;
  5. kernel-bwd — the dK/dV and dQ kernels against the plain backward, and
               gradients through the autograd Function against autograd of
               the plain attention, at the shapes of phase 3 and one tile
               (S=64); a second call must give bit-equal results; bad shapes
               raise; median times at the train step's shape, beside
               torch's scaled_dot_product_attention (forward, and its
               backward alone) as the library yardstick;
  6. train   — ``python -m tst_torch diagnose-sft`` (Qwen2.5-0.5B at full
               width, k=2 folds x 16 rows, 3 epochs, LoRA r16 on q/k/v/o,
               bf16, synthetic:0.5, n=512) through the CLI entry point; the
               three kernels' launch counts must be what the run's own step
               and chunk counts imply; report.json and the s(x) table, with
               the RF cross-check of the default config (a finite
               rf_sft_spearman and rf_blind_accuracy, and its wall); then
               the median train-step time after the first step;
  7. train, kernel vs plain — one fold-parallel step's LoRA gradients and
               losses through the kernels against ``model.use_pallas=false``
               on the same weights, adapters and batch (4 rows per fold);
  8. kernel-seg — the segmented (packed-row) forward, dK/dV and dQ kernels
               against their plain versions, and gradients through the
               autograd Function against autograd of the plain masked
               attention: at the packed train step's call with the run's own
               segment starts, at Llama-3-8B heads with 8 segments a row at
               S=2048, and at 128- and 64-token cases (64 at both head dims)
               with starts inside tiles and a row of all SEG_PAD; forward and
               backward bit-equal on a second call;
               bad starts raise; median times of the segmented kernels, the
               unsegmented ones, the plain versions and scaled_dot_product_
               attention with the boolean segment mask at the train step's
               shape;
  9. train-packed — ``python -m tst_torch diagnose-sft --set optim.pack=true``
               (phase 6's run, train and held-out rows packed three samples
               to a row of 1024): the segmented kernels' launch counts must
               be what the run's steps and scorer chunks imply, and the
               unsegmented kernels must not run; report.json and the s(x)
               table; the median train-step time after the first;
 10. train-packed, kernel vs plain — one packed step's LoRA gradients and
               losses (2 packed rows per fold) and the packed scorer's letter
               probabilities through the kernels against the plain path;
 11. kernel-int4 — the packed-int4 dequant-matmul (K3) against its plain
               version at decode's M (32, 64) for each int4 leaf of
               Qwen2.5-0.5B and of Llama-3-8B, layer 1 of a stacked [2, K, N/2]
               leaf, bit-equal on a second call, one kernel a call (the
               kernel nodes of a CUDA graph of one call);
               at every Qwen shape the device time a call (a CUDA graph of 10
               calls, replayed: no host in it) and the host time a call (the
               public entry, back to back), summed over a decode layer's
               seven projections at M=32 and M=64;
 12. kernel-mlp — the fused SwiGLU MLP (K4) against its plain version at the
               int4 train step's shape, at Llama-3-8B widths and at an M that
               is no tile multiple, bit-equal on a second call; gradients
               through the autograd Function against autograd of the plain
               version; at the train shape the median time of the call and
               of each of its two kernels, with TFLOP/s, the decoder's
               unfused bf16 MLP and the bound;
 13. decode-slice — ``python -m tst_torch eval-blind`` on synthetic-vsi:0.4
               (384 MCQ + 128 numeric rows, n=512) with ``model.quantize=int4``
               through the CLI: launch counts as the run implies (K3 on every
               int4 projection of every decode step); the first decode step's
               logits through K3 against the plain path on the same caches
               (no decisive first-token disagreement);
               decode step times, the device's idle share and K3's share of
               the busy time (profiler);
 14. train-fused — ``python -m tst_torch diagnose-sft`` on synthetic-vsi:0.4
               with ``model.quantize=int4 model.fused_mlp=true`` through the
               CLI: launch counts as implied (K4 on every train-step MLP, K3 on
               the held-out decode of both folds' rows at once); report.json
               and the s(x) table; one step's LoRA gradients and fold losses
               against the unfused plain path; median step time fused against
               unfused, their peak device memory, and a profile of the fused
               step;
 15. diagnose-rf — ``python -m tst_torch diagnose-rf`` (synthetic:0.5, n=512,
               k=5) through the CLI, the port's own forest fit on the host and
               the forests traversed on the card: each fold's forest traversed
               on the host path gives probabilities within 1e-6 and the same
               s(x) ranking; no kernel launches; blind accuracy above chance
               (the benchmark plants a length bias); the fit's wall and the
               traversal's time on the card;
 16. debias-ibp — ``python -m tst_torch debias-ibp`` (Qwen2.5-0.5B at full
               width, bf16, synthetic-vsi:0.4, n=512, phase 6's training, 3
               rounds, stop_epsilon -1) through the CLI: 3 rounds; the audit
               rows, debiased.jsonl + removed.jsonl and sx.jsonl's kept column
               add up; ibp_report.json is strict JSON; the three attention
               kernels launch as the rounds' own steps, scorer chunks and
               decode prefills imply; round 0's held-out MCQ s(x) on its final
               adapters through the plain attention at Spearman >= 0.999; each
               round's stage walls and the peak device memory;
 17. debias-ibp-rf — the same subcommand with ``ibp.diagnostic=rf``
               (synthetic:0.5, n=512, k=3, 2 rounds): each round prunes
               prune_mask's budget, the audit and split add up, no kernel
               launches.

The second-to-last line is the per-kernel JSON record (launches on the
main path, error, kernel, plain and library times, and the bound: the
larger of the function's bytes over 3.35 TB/s and its operations over
989 TFLOP/s bf16, counted from this run's shapes and masks), the last line
``{"ok": true, "device": {...}}``. Imports nothing of jax or of the JAX
package ``tst``, and neither does the port it drives.
"""

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SLICE = ["eval-blind", "--bench", "synthetic:0.5", "--set", "data.n=512",
         "--set", "model.name=qwen2.5-0.5b"]  # default --platform gpu, bf16, use_pallas
N_SAMPLES, N_LAYERS, SCORER_BATCH = 512, 24, 32
#: (B, S, H, KVH, D): the slice's own attention call, Llama-3-8B heads, one tile
KERNEL_SHAPES = [(32, 512, 14, 2, 64), (2, 2048, 32, 8, 128), (4, 128, 14, 2, 64)]
#: the kernels also at one tile (S=64), at both head dims
ONE_TILE = [(3, 64, 14, 2, 64), (2, 64, 8, 2, 128)]
#: the card's peaks for the bounds (NVIDIA H100 SXM data sheet: dense bf16,
#: HBM3)
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
#: bf16 output: one rounding of P and of o (|o| < 2) -> 2e-2; f32 lse -> 1e-3
O_TOL, LSE_TOL = 2e-2, 1e-3
#: letter probabilities of the kernel path vs the plain path, bf16 model
PROB_TOL, ARGMAX_AGREE = 0.05, 0.95
#: the train step's attention call: 2 folds x 16 rows, Qwen2.5-0.5B heads
TRAIN_SHAPE = (32, 512, 14, 2, 64)
#: bf16 gradients against an f32 plain backward: P and dS are rounded to bf16
#: as operands, and dk/dv sum over 7 heads x up to 512 rows, so each gradient
#: is held to max|d - ref| <= 2e-2 * max|ref|
GRAD_TOL = 2e-2
TRAIN = ["diagnose-sft", "--bench", "synthetic:0.5", "--set", "data.n=512",
         "--set", "data.k=2", "--set", "optim.batch_size=16", "--set", "optim.epochs=3",
         "--set", "model.name=qwen2.5-0.5b"]  # the default rf.cross_check=true
#: rows per fold of the kernel-vs-plain step: the plain attention keeps
#: several f32 [rows, 14, 512, 512] tensors per layer for its backward
PLAIN_ROWS = 4
#: one bf16 step, kernel vs plain path: per-leaf LoRA gradient cosine, and
#: per-fold losses within LOSS_RTOL of the plain loss: bf16 rounding through
#: 24 layers moves the logits, and the loss with them, in proportion to
#: their size (~13 nats at random weights: gaps of 5.6e-3 to 7.7e-3, PERF.md)
GRAD_COSINE, LOSS_RTOL = 0.99, 1e-3
#: scale of the drawn LoRA B for that step (nonzero, so A has gradients)
B_SCALE = 0.005
STEP_SAMPLES = 8
PACKED = ["optim.pack=true"]
#: the packed train step's attention call: 2 folds x 16 rows of 1024 tokens
PACKED_TRAIN_SHAPE = (32, 1024, 14, 2, 64)
#: the other segmented checks: Llama-3-8B heads at S=2048, 8 segments a row
#: (where the TPU dispatches its chunked K2 bodies); 128- and 64-token cases
SEG_SHAPES = [(2, 2048, 32, 8, 128), (5, 128, 14, 2, 64), (5, 64, 14, 2, 64),
              (3, 64, 8, 2, 128)]
#: segment starts a row (kernel layout) and the unused slot
MAX_SEGS, SEG_PAD = 8, 1 << 30
#: packed rows per fold of the kernel-vs-plain step: the plain attention keeps
#: several f32 [rows, 14, 1024, 1024] tensors per layer for its backward
PACKED_PLAIN_ROWS = 2
#: K3 at decode's M: Path A's chunk of 32 rows; Path B's 2 folds x 32 rows
INT4_M = (32, 64)
#: (K, N) of Qwen2.5-0.5B's seven int4 projections, in a layer's order
QWEN_INT4 = {"wq": (896, 896), "wk": (896, 128), "wv": (896, 128), "wo": (896, 896),
             "w_gate": (896, 4864), "w_up": (896, 4864), "w_down": (4864, 896)}
#: Llama-3-8B's int4 leaves: q/o, k/v, gate/up, down
LLAMA_INT4 = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
#: the same bf16-rounded weights, f32 sums in another order
INT4_TOL = 1e-2
#: K4: the int4 train step (2 folds x 16 rows x 512 tokens), Llama-3-8B
#: widths, and an M that is no multiple of the kernel's 32-row tile
MLP_SHAPES = [(16384, 896, 4864), (2048, 4096, 14336), (1000, 896, 4864)]
#: bf16 output and h rounded to bf16 before the down product
MLP_TOL = 2e-2
DECODE = ["eval-blind", "--bench", "synthetic-vsi:0.4", "--set", "data.n=512",
          "--set", "model.name=qwen2.5-0.5b", "--set", "model.quantize=int4"]
#: synthetic-vsi:0.4 at n=512: 384 MCQ rows and 128 numeric rows
N_MCQ_VSI, N_NUMERIC_VSI = 384, 128
#: greedy tokens of a numeric answer (the reference's max_new), the int4
#: projections of a layer, and the decode step's rows of Path A
MAX_NEW, INT4_PROJ, DECODE_ROWS = 12, 7, 32
#: the first decode step's f32 logits, K3 against the plain path on the same
#: caches: max |Δ| <= 2e-2 max |logit| (a random bf16 model of 24 layers: the
#: plain path with its f32 sums taken in another order moves its logits as
#: far, PERF.md), and no decisive first-token disagreement
#: (decisive_disagreements): the logits are near-tied, so argmax agreement
#: alone fails correct code
LOGIT_TOL = 2e-2
TRAIN_FUSED = ([a.replace("synthetic:0.5", "synthetic-vsi:0.4") for a in TRAIN]
               + ["--set", "model.quantize=int4", "--set", "model.fused_mlp=true"])
#: the RF auditor on the planted-bias benchmark (forests traversed on the card)
RF = ["diagnose-rf", "--bench", "synthetic:0.5", "--set", "data.n=512", "--k", "5"]
#: the device traversal against the host one: the same trees, f32 mean over
#: trees against sklearn's f64 sum
RF_TOL = 1e-6
#: IBP with the SFT diagnostic on phase 14's mix, the train geometry of phase
#: 6; stop_epsilon -1, so the loop at random weights (blind accuracy near
#: chance) still prunes every round
IBP_ROUNDS = 3
IBP = ["debias-ibp", "--bench", "synthetic-vsi:0.4", "--set", "data.n=512", "--k", "2",
       "--set", "optim.batch_size=16", "--set", "optim.epochs=3",
       "--set", f"ibp.rounds={IBP_ROUNDS}", "--set", "ibp.stop_epsilon=-1",
       "--set", "model.name=qwen2.5-0.5b"]
#: round 0's held-out MCQ s(x), kernels against the plain attention on the
#: same adapters: the bf16 rank rule (ROADMAP, "Hold parity on the same inputs")
IBP_SPEARMAN = 0.999
IBP_RF_ROUNDS = 2
IBP_RF = ["debias-ibp", "--bench", "synthetic:0.5", "--set", "data.n=512", "--k", "3",
          "--set", "ibp.diagnostic=rf", "--set", f"ibp.rounds={IBP_RF_ROUNDS}",
          "--set", "ibp.stop_epsilon=-1"]
#: prune_mask's floor of survivors
IBP_MIN_KEEP = 8


def median_ms(fn, samples=30, reps=10, warmup=3):
    """Median over ``samples`` CUDA-event timings of ``reps`` back-to-back
    calls, per call: the host's launch overhead hides behind the device
    work, as it does inside the model."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


#: a flash-attention kernel's mangled name: which kernel, D, kSeg
_FLASH_KERNEL = re.compile(r"flash_(?:bwd_)?(fwd|dkv|dq)_kernelILi(\d+)ELb([01])E")
#: the attention kernels' instantiations: {fwd, dkv, dq} x D {64, 128} x {plain, seg}
N_ATTENTION_KERNELS = 12
#: K4's two kernels, which must run their products on wgmma too
K4_KERNELS = ("swiglu_gate_up_kernel", "swiglu_down_kernel")
_K4_KERNEL = re.compile(r"\d+(" + "|".join(K4_KERNELS) + r")(?=E|I)")


def kernel_name(mangled):
    """A short name for a kernel's mangled name: ``fwd<D=64, seg>`` for the
    attention kernels, else the last name of the nested name with its int
    template arguments (``fused_mlp_kernel<8>``, ``int4_matmul_kernel<2, 4>``)."""
    m = _FLASH_KERNEL.search(mangled)
    if m:
        return f"{m[1]}<D={m[2]}{', seg' if m[3] == '1' else ''}>"
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while m := re.match(r"\d+", mangled[i:]):
        i += len(m[0])
        name, i = mangled[i:i + int(m[0])], i + int(m[0])
    m = re.match(r"I((?:Li\d+E)+)E", mangled[i:])
    return f"{name}<{', '.join(re.findall(r'Li(\d+)E', m[1]))}>" if m else name


def hgmma_counts(sass):
    """HGMMA (wgmma) instructions in each attention kernel and each K4
    kernel of a ``cuobjdump -sass`` listing, by short name."""
    counts, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = _FLASH_KERNEL.search(ln)
            k4 = _K4_KERNEL.search(ln)
            name = kernel_name(m[0]) if m else (k4[1] if k4 else None)
            if name:
                counts[name] = 0
        elif name and "HGMMA" in ln:
            counts[name] += 1
    return counts


def check_hgmma(counts):
    """Every attention kernel (forward, dK/dV, dQ at both head dims, plain
    and segmented) and both K4 kernels must run their products on wgmma."""
    attention = {k: v for k, v in counts.items() if k not in K4_KERNELS}
    if (len(attention) != N_ATTENTION_KERNELS or any(k not in counts for k in K4_KERNELS)
            or min(counts.values(), default=0) == 0):
        raise AssertionError(f"each of the {N_ATTENTION_KERNELS} attention kernels and the K4 "
                             f"kernels {K4_KERNELS} must run its products on wgmma: {counts}")


def ptxas_usage(log):
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v`` log,
    by short name."""
    usage, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", ln)
        if m:
            name = kernel_name(m[1])
            usage.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if name and m:
            usage[name]["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", ln)
        if name and m:
            usage[name]["registers"] = int(m[1])
    return usage


def decisive_disagreements(lk, lp, tol=LOGIT_TOL):
    """First-token disagreements of one chunk's f32 logits [rows, vocab],
    the kernel path ``lk`` against the plain path ``lp``: (rows whose argmax
    differs, the decisive ones among them, the plain path's top-2 gap on each
    differing row). A disagreement is decisive when that gap exceeds twice
    the largest error the logit gate lets through, ``tol · max|lp|``: an
    error within the tolerance could not have flipped the row. (Twice the
    chunk's own max |lk - lp| would count 0 by construction: a row flips only
    where its gap is at most twice its own largest error.)"""
    differ = lk.argmax(-1) != lp.argmax(-1)
    top2 = lp.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decisive = differ & (gap > 2 * tol * lp.abs().max())
    return int(differ.sum()), int(decisive.sum()), gap[differ].tolist()


def fold_losses_agree(loss_k, loss_p):
    """(max over folds of |loss_k - loss_p| / |loss_p|, whether it is within
    LOSS_RTOL); NaN fails."""
    k, p = np.asarray(loss_k, np.float64), np.asarray(loss_p, np.float64)
    gap = float(np.max(np.abs(k - p) / np.abs(p)))
    return gap, bool(gap <= LOSS_RTOL)


def strict_json(text):
    """``json.loads`` that refuses NaN and ±Infinity, which Python's json
    writes and a strict reader rejects."""
    def refuse(name):
        raise ValueError(f"not strict JSON: {name}")

    return json.loads(text, parse_constant=refuse)


def check_audit(report, n):
    """An IBP report's rounds add up: round 0 starts from all ``n`` rows,
    each round's n_alive is the previous round's less what it pruned, and
    the last round's less what it pruned is n_debiased."""
    rows = report["per_round"]
    alive = [row["n_alive"] for row in rows]
    pruned = [row.get("pruned_this_round", 0) for row in rows]
    want = [n] + [a - p for a, p in zip(alive, pruned)]
    if not rows or alive + [report["n_debiased"]] != want:
        raise AssertionError(f"IBP audit does not add up: n_alive {alive}, pruned {pruned}, "
                             f"n_debiased {report['n_debiased']}, n {n}")


def check_split(n, kept_ids, removed_ids, sx_rows):
    """debiased.jsonl and removed.jsonl partition the ``n`` rows, and the
    ``kept`` column of sx.jsonl names the same rows."""
    kept, removed = set(kept_ids), set(removed_ids)
    sx_kept = {r["id"] for r in sx_rows if r["kept"] == 1.0}
    sx_removed = {r["id"] for r in sx_rows if r["kept"] == 0.0}
    if (len(kept_ids) + len(removed_ids) != n or kept & removed or len(sx_rows) != n
            or sx_kept != kept or sx_removed != removed):
        raise AssertionError(f"IBP split: {len(kept_ids)} kept + {len(removed_ids)} removed "
                             f"of {n}; sx.jsonl {len(sx_rows)} rows, {len(sx_kept)} kept, "
                             f"{len(sx_removed)} removed")


def ibp_launches_want(plan, n_layers=N_LAYERS):
    """The attention kernels' launches that IBP rounds imply, each round of
    ``plan`` given as its train steps, scorer chunks and decode prefill
    chunks (summed over the round's seeds and scoring passes): one forward a
    layer for each step, chunk and prefill, one dK/dV and one dQ a layer for
    each step, and nothing else."""
    steps = sum(p["steps"] for p in plan)
    fwd = steps + sum(p["scorer_chunks"] + p["decode_chunks"] for p in plan)
    return {"fwd": n_layers * fwd, "dkv": n_layers * steps, "dq": n_layers * steps,
            "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0, "int4": 0, "mlp": 0}


def check_launches(counts, want, what):
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")


def same_ranking(s_dev, s_host, tol=2 * RF_TOL):
    """The host s(x)'s order (most biased first, NaN last, ties by index)
    sorts the device s(x) too: NaN in the same rows, and no later row above
    an earlier one by more than ``tol`` (what the traversals' rounding can
    move)."""
    s_dev, s_host = np.asarray(s_dev, np.float64), np.asarray(s_host, np.float64)
    if not np.array_equal(np.isnan(s_dev), np.isnan(s_host)):
        return False
    order = np.argsort(-np.where(np.isnan(s_host), -np.inf, s_host), kind="stable")
    ranked = s_dev[order][np.isfinite(s_dev[order])]
    return bool(np.all(np.diff(ranked) <= tol))


def pruned_as_implied(report, rate, min_keep=IBP_MIN_KEEP):
    """Every round pruned prune_mask's budget, round(rate · n_alive) capped
    at n_alive - min_keep: what a set with a finite s(x) on every row
    implies."""
    return all(row.get("pruned_this_round") == min(int(round(rate * row["n_alive"])),
                                                   row["n_alive"] - min_keep)
               for row in report["per_round"])


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tst_torch.runtime.device import select_device

    device = select_device("gpu")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(smi)  # name, power limit: exactly as nvidia-smi reports them
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}")
    return device


def phase_build(sass=True):
    from tst_torch.kernels import _build

    res = _build.build()
    usage = ptxas_usage(res.log)
    print(f"[build] {res.path.name} nvcc {res.seconds:.1f} s; registers and spill bytes: "
          f"{json.dumps(usage)}")
    for ln in res.log.splitlines():
        if "warning" in ln:
            print(f"[build] ptxas: {ln.strip()}")
    if not sass:
        return
    # wgmma in the attention kernels: HGMMA instructions in each one's SASS
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    counts = hgmma_counts(subprocess.run([cuobjdump, "-sass", str(res.path)], check=True,
                                         capture_output=True, text=True).stdout)
    print(f"[build] HGMMA instructions in the attention and K4 kernels' SASS: {counts}")
    check_hgmma(counts)


def phase_kernel(device):
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for b, s, h, kvh, d in KERNEL_SHAPES + ONE_TILE:
        rng = np.random.default_rng(s + d)
        q, k, v = (torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32))
                   .to(device, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        o, lse = tfa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention(q, k, v), (o, lse), "the forward kernel")
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v)
        torch.cuda.synchronize()
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        ok = o_err <= O_TOL and lse_err <= LSE_TOL and bool(torch.isfinite(o).all())
        print(f"[kernel] B={b} S={s} H={h} KVH={kvh} D={d}: max|o-ref| {o_err:.3e} "
              f"(<= {O_TOL}), max|lse-ref| {lse_err:.3e} (<= {LSE_TOL})")
        if not ok:
            raise AssertionError(f"flash_attention disagrees with its plain version "
                                 f"at {(b, s, h, kvh, d)}")
        if (b, s, h, kvh, d) == KERNEL_SHAPES[0]:
            out["max_abs_err"] = o_err
            out["ms"] = median_ms(lambda: tfa.flash_attention(q, k, v))
            out["plain_ms"] = median_ms(lambda: tfa.flash_attention_reference(q, k, v))
    bad = torch.zeros(1, 100, 2, 64, device=device, dtype=torch.bfloat16)
    try:
        tfa.flash_attention(bad, bad, bad)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention accepted S=100")
    print(f"[kernel] bit-equal on a second call at every shape; S=100 rejected; slice shape "
          f"{KERNEL_SHAPES[0]}: kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms "
          f"(median of 30 x 10 calls)")
    return out


def _randn(rng, shape, device):
    return (torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32))
            .to(device, torch.bfloat16))


def _rel_err(got, want):
    """max |got - want| / max |want|, in f32."""
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _bound(flops, nbytes):
    """The least time the card could take: the larger of the operations over
    the bf16 peak and the bytes (each input read once, each output written
    once) over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _attention_bounds(q, k, seg=None):
    """Bounds of the forward, the dK/dV and the dQ functions at these
    shapes: products over the (query, key) pairs the mask keeps (causal,
    and packed within each segment: this run's starts), 2·D operations a
    pair each: forward Q·Kᵀ, P·V; dK/dV Sᵀ, dPᵀ, dV, dK; dQ S, dP, dQ."""
    import tst_torch.kernels.flash_attention as tfa

    b, s, h, d = q.shape
    if seg is None:
        pairs = b * h * s * (s + 1) // 2
    else:
        start = tfa.segment_starts_per_pos(seg, s).long()
        pairs = h * int((torch.arange(s, device=seg.device) - start + 1).sum().item())
    qb, kvb, stat = q.numel() * 2, k.numel() * 2 * 2, b * h * s * 4
    segb = 0 if seg is None else seg.numel() * 4
    return {"fwd": _bound(4 * d * pairs, 2 * qb + kvb + stat + segb),
            "dkv": _bound(8 * d * pairs, 2 * qb + 2 * kvb + 2 * stat + segb),
            "dq": _bound(6 * d * pairs, 3 * qb + kvb + 2 * stat + segb)}


def _sdpa_yardstick(q, k, v, do, o, mask=None):
    """library_ms of the attention function: one call of torch's
    scaled_dot_product_attention on [B, H, S, D] views of the same q, k, v
    (causal, or the boolean [B, 1, S, S] segment mask), and its backward
    (``torch.autograd.grad`` of o on its graph) timed alone. The backend is
    pinned, the first of flash, cuDNN and memory-efficient that runs (flash
    takes no mask); GQA through ``enable_gqa``, else k and v expanded to H
    heads outside the timed region. The port never calls it."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = q.shape[2] // k.shape[2]
    backends = [SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]
    if mask is None:
        backends.insert(0, SDPBackend.FLASH_ATTENTION)
    for backend in backends:
        for gqa in (True, False):
            qh = q.transpose(1, 2).detach().requires_grad_()
            kh, vh = (t.transpose(1, 2) if gqa else t.transpose(1, 2).repeat_interleave(g, 1)
                      for t in (k, v))
            kh, vh = kh.detach().requires_grad_(), vh.detach().requires_grad_()
            doh = do.transpose(1, 2)
            kw = ({"is_causal": True} if mask is None else {"attn_mask": mask[:, None]})
            if gqa:
                kw["enable_gqa"] = True
            try:
                with sdpa_kernel(backend):
                    oh = sdpa(qh, kh, vh, **kw)
                    torch.autograd.grad(oh, (qh, kh, vh), doh, retain_graph=True)
                torch.cuda.synchronize()
            except RuntimeError:
                continue
            with sdpa_kernel(backend):
                with torch.no_grad():
                    fwd_ms = median_ms(lambda: sdpa(qh, kh, vh, **kw))
                bwd_ms = median_ms(lambda: torch.autograd.grad(oh, (qh, kh, vh), doh,
                                                               retain_graph=True))
            err = (oh.detach().transpose(1, 2).float() - o.float()).abs().max().item()
            if err > O_TOL:
                raise AssertionError(f"scaled_dot_product_attention disagrees with the kernel's "
                                     f"o: {err:.3e}")
            return {"backend": backend.name,
                    "gqa": "enable_gqa" if gqa else "k, v expanded to H heads, untimed",
                    "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "max_abs_o_diff": err}
    raise AssertionError("no scaled_dot_product_attention backend ran")


def _check_bitwise(fn, got, what="the backward kernels"):
    """A second call of ``fn`` must give bit-equal outputs (no atomics, one
    fixed summation order)."""
    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{what}: not bit-reproducible")


def phase_kernel_bwd(device):
    """The dK/dV and dQ kernels against the plain backward (f32, same o and
    lse), and gradients through the autograd Function against autograd of
    the plain attention, at the forward's three shapes."""
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for b, s, h, kvh, d in KERNEL_SHAPES + ONE_TILE:
        rng = np.random.default_rng(s + d + 1)
        q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
        k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
        o, lse = tfa.flash_attention(q, k, v)
        got = tfa.flash_attention_backward(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention_backward(q, k, v, o, lse, do), got)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float())
        errs = [_rel_err(g, w) for g, w in zip(got, want)]

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
        tfa.flash_attention(*leaves)[0].backward(do)
        if (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) != (before[0] + 1, before[1] + 1):
            raise AssertionError("the autograd Function's backward did not launch both kernels")
        plain = [t.detach().requires_grad_() for t in (q, k, v)]
        tfa.masked_attention(*plain, torch.ones(s, s, dtype=torch.bool, device=device).tril()
                             )[0].backward(do)
        torch.cuda.synchronize()
        auto_errs = [_rel_err(a.grad, p.grad) for a, p in zip(leaves, plain)]
        finite = all(bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for g in got)
        print(f"[kernel-bwd] B={b} S={s} H={h} KVH={kvh} D={d}: max|d-ref|/max|ref| "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; through autograd vs "
              f"plain attention dq {auto_errs[0]:.3e} dk {auto_errs[1]:.3e} "
              f"dv {auto_errs[2]:.3e} (each <= {GRAD_TOL})")
        if not finite or max(errs + auto_errs) > GRAD_TOL:
            raise AssertionError(f"flash-attention backward disagrees with its plain "
                                 f"version at {(b, s, h, kvh, d)}")
        if (b, s, h, kvh, d) == TRAIN_SHAPE:
            di = tfa.backward_row_stat(o, do)
            plain_ms = median_ms(lambda: tfa.flash_attention_backward_reference(
                q, k, v, o, lse, do))
            lib = _sdpa_yardstick(q, k, v, do, o)
            bounds = _attention_bounds(q, k)
            out["dkv"] = {"max_abs_err": (got[1].float() - want[1]).abs().max().item(),
                          "ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di)),
                          "plain_ms": plain_ms, "library_ms": lib["bwd_ms"], **bounds["dkv"]}
            out["dq"] = {"max_abs_err": (got[0].float() - want[0]).abs().max().item(),
                         "ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di)),
                         "plain_ms": plain_ms, "library_ms": lib["bwd_ms"], **bounds["dq"]}
            out["fwd"] = {"library_ms": lib["fwd_ms"], **bounds["fwd"]}
            both_ms = median_ms(lambda: tfa.flash_attention_backward(q, k, v, o, lse, do))
    bad = torch.zeros(1, 100, 2, 64, device=device, dtype=torch.bfloat16)
    lse_bad = torch.zeros(1, 2, 100, device=device)
    try:
        tfa.flash_attention_backward(bad, bad, bad, bad, lse_bad, bad)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention_backward accepted S=100")
    dkv, dq = out["dkv"], out["dq"]
    print(f"[kernel-bwd] bit-equal on a second call at every shape; S=100 rejected; train "
          f"shape {TRAIN_SHAPE}: dkv {dkv['ms']:.4f} ms (bound {dkv['bound_ms']:.4f}, "
          f"{dkv['bound_by']}) + dq {dq['ms']:.4f} ms (bound {dq['bound_ms']:.4f}, "
          f"{dq['bound_by']}); wrapper (di, checks, both kernels) {both_ms:.4f} ms; plain "
          f"backward {plain_ms:.4f} ms; scaled_dot_product_attention ({lib['backend']}, "
          f"{lib['gqa']}; max|o-o_kernel| {lib['max_abs_o_diff']:.3e}): backward alone "
          f"{lib['bwd_ms']:.4f} ms, forward {lib['fwd_ms']:.4f} ms (forward kernel bound "
          f"{out['fwd']['bound_ms']:.4f}, {out['fwd']['bound_by']}) (median of 30 x 10 calls)")
    return out


def phase_rank(device, rounds=5):
    """Which attention kernels lose most to the library, interleaved over
    ``rounds`` in one process (medians): at the train step's shape the
    forward kernel against scaled_dot_product_attention's forward and the
    backward pair (dK/dV + dQ kernels) against its backward; at the packed
    train step's shape, with that step's own segment starts, the segmented
    forward against the library's forward with the boolean segment mask.
    The forward is ranked above the pair only if it is slower than the
    library's forward and loses to it by a larger factor than the pair
    loses to the library's backward."""
    import tst_torch.kernels.flash_attention as tfa

    b, s, h, kvh, d = TRAIN_SHAPE
    rng = np.random.default_rng(s + d + 1)
    q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
    k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
    o, lse = tfa.flash_attention(q, k, v)
    di = tfa.backward_row_stat(o, do)

    def pair():
        tfa._launch_bwd_dkv(q, k, v, do, lse, di)
        tfa._launch_bwd_dq(q, k, v, do, lse, di)

    b, s, h, kvh, d = PACKED_TRAIN_SHAPE
    rng = np.random.default_rng(s + d + 2)
    pq, pdo = (_randn(rng, (b, s, h, d), device) for _ in range(2))
    pk, pv = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
    seg = torch.from_numpy(_packed_step_starts()).to(device)
    kseg = tfa.kernel_seg_starts(seg, pq)
    po = tfa.flash_attention(pq, pk, pv, seg_starts=seg)[0]
    mask = tfa.segment_mask(seg, s)

    times = {"fwd": [], "pair": [], "fwd_seg": [], "library_fwd": [], "library_bwd": [],
             "library_fwd_seg": []}
    for _ in range(rounds):
        times["fwd"].append(median_ms(lambda: tfa._launch_fwd(q, k, v)))
        times["pair"].append(median_ms(pair))
        times["fwd_seg"].append(median_ms(lambda: tfa._launch_fwd(pq, pk, pv, kseg)))
        lib = _sdpa_yardstick(q, k, v, do, o)
        times["library_fwd"].append(lib["fwd_ms"])
        times["library_bwd"].append(lib["bwd_ms"])
        lib_seg = _sdpa_yardstick(pq, pk, pv, pdo, po, mask)
        times["library_fwd_seg"].append(lib_seg["fwd_ms"])
    med = {key: statistics.median(val) for key, val in times.items()}
    f_fwd, f_pair = med["fwd"] / med["library_fwd"], med["pair"] / med["library_bwd"]
    f_seg = med["fwd_seg"] / med["library_fwd_seg"]
    first = ("forward" if med["fwd"] > med["library_fwd"] and f_fwd > f_pair
             else "backward pair")
    print(f"[rank] {rounds} interleaved rounds (medians; per round "
          f"{json.dumps({key: [round(x, 4) for x in val] for key, val in times.items()})}): "
          f"train shape {TRAIN_SHAPE}: forward {med['fwd']:.4f} ms vs "
          f"scaled_dot_product_attention ({lib['backend']}, {lib['gqa']}) "
          f"{med['library_fwd']:.4f} ms, factor {f_fwd:.3f}; backward pair "
          f"{med['pair']:.4f} ms vs {med['library_bwd']:.4f} ms, factor {f_pair:.3f}; "
          f"loses most: the {first}; packed shape {PACKED_TRAIN_SHAPE}, "
          f"{int((seg < SEG_PAD).sum())} segment starts: segmented forward "
          f"{med['fwd_seg']:.4f} ms vs the library with the segment mask ({lib_seg['backend']}, "
          f"{lib_seg['gqa']}) {med['library_fwd_seg']:.4f} ms, factor {f_seg:.3f}")


def phase_slice():
    import tst_torch.kernels.flash_attention as tfa
    from tst_torch import cli
    from tst_torch.train.infer import score_all_mcq
    from tst_torch.train.pipeline import prepare_blind_eval

    out_dir = tempfile.mkdtemp(prefix="tst_torch_smoke_")
    tfa.LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(SLICE + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tfa.LAUNCHES
    want = N_LAYERS * math.ceil(N_SAMPLES / SCORER_BATCH)
    if rc != 0 or launches != want:
        raise AssertionError(f"eval-blind rc={rc}, kernel launches {launches} != {want}")
    with open(os.path.join(out_dir, "blind_eval.json")) as f:
        report = json.load(f)
    acc = report["blind_accuracy"]
    if report["n_mcq"] != N_SAMPLES or not (math.isfinite(acc) and 0.0 <= acc <= 1.0):
        raise AssertionError(f"bad blind_eval.json: {report}")
    print(f"[slice] eval-blind rc=0, {launches} kernel launches, blind_accuracy {acc:.4f} "
          f"(chance {report['chance_accuracy']:.4f}), wall {wall:.2f} s "
          f"({N_SAMPLES / wall:.1f} samples/s incl. init and tokenization)")

    # the same tokens and weights, scored through the kernel and the plain attention
    cfg, device = cli._resolve(cli.build_parser().parse_args(SLICE))
    tb, tokens, pos, spec, params = prepare_blind_eval(cli._load_dataset(cfg), cfg, device)
    probs, secs = {}, {}
    for use_pallas in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs[use_pallas] = score_all_mcq(params, spec, tokens, pos, tb.option_token_ids,
                                          tb.n_options, use_pallas=use_pallas)
        secs[use_pallas] = time.perf_counter() - t0
    pk, pp = probs[True], probs[False]
    if pk.shape != (N_SAMPLES, 4) or not np.isfinite(pk).all():
        raise AssertionError(f"kernel-path probabilities: shape {pk.shape}, finite "
                             f"{np.isfinite(pk).all()}")
    diff = float(np.abs(pk - pp).max())
    agree = float((pk.argmax(-1) == pp.argmax(-1)).mean())
    acc_k = float((pk.argmax(-1) == tb.gold).mean())
    print(f"[slice] kernel vs plain attention: max|dprob| {diff:.3e} (<= {PROB_TOL}), "
          f"argmax agreement {agree:.4f} (>= {ARGMAX_AGREE}); rescored accuracy {acc_k:.4f}; "
          f"scoring {secs[True]:.3f} s kernel ({N_SAMPLES / secs[True]:.1f} samples/s), "
          f"{secs[False]:.3f} s plain")
    if diff > PROB_TOL or agree < ARGMAX_AGREE or abs(acc_k - acc) > 1.0 / N_SAMPLES:
        raise AssertionError("kernel path and plain path disagree on the slice")
    return launches


def _launch_counts():
    import tst_torch.kernels.flash_attention as tfa
    import tst_torch.kernels.fused_mlp as tfm
    import tst_torch.kernels.quant_matmul as tqm

    return {"fwd": tfa.LAUNCHES, "dkv": tfa.LAUNCHES_BWD_DKV, "dq": tfa.LAUNCHES_BWD_DQ,
            "fwd_seg": tfa.LAUNCHES_SEG, "dkv_seg": tfa.LAUNCHES_SEG_BWD_DKV,
            "dq_seg": tfa.LAUNCHES_SEG_BWD_DQ, "int4": tqm.LAUNCHES, "mlp": tfm.LAUNCHES}


def _zero_launch_counts():
    import tst_torch.kernels.flash_attention as tfa
    import tst_torch.kernels.fused_mlp as tfm
    import tst_torch.kernels.quant_matmul as tqm

    tfa.LAUNCHES = tfa.LAUNCHES_BWD_DKV = tfa.LAUNCHES_BWD_DQ = 0
    tfa.LAUNCHES_SEG = tfa.LAUNCHES_SEG_BWD_DKV = tfa.LAUNCHES_SEG_BWD_DQ = 0
    tqm.LAUNCHES = tfm.LAUNCHES = 0


def _train_state(overrides=(), base=TRAIN):
    """The diagnose-sft run's state (weights, adapters, batches) built as
    the CLI builds it from ``base``, with extra ``--set`` overrides."""
    from tst_torch import cli
    from tst_torch.train.pipeline import _build_sft_state

    argv = base + [a for o in overrides for a in ("--set", o)]
    cfg, device = cli._resolve(cli.build_parser().parse_args(argv))
    return _build_sft_state(cli._load_dataset(cfg), cfg, device)


def phase_train():
    from tst_torch import cli

    out_dir = tempfile.mkdtemp(prefix="tst_torch_train_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(TRAIN + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "sx.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    folds = np.array([r["fold"] for r in rows])
    k, steps = report["k"], report["train_steps"]
    chunks = k * math.ceil(max(int((folds == f).sum()) for f in range(k)) / SCORER_BATCH)
    want = {"fwd": N_LAYERS * (steps + chunks), "dkv": N_LAYERS * steps,
            "dq": N_LAYERS * steps, "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0, "int4": 0,
            "mlp": 0}
    loss = report["final_loss"]
    sx = np.array([r["s_x"] for r in rows], np.float64)
    rf_rho, rf_acc = report.get("rf_sft_spearman"), report.get("rf_blind_accuracy")
    if (rc != 0 or counts != want or report["n_mcq"] != N_SAMPLES or len(rows) != N_SAMPLES
            or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()
            or not all(isinstance(v, float) and math.isfinite(v) for v in (rf_rho, rf_acc))):
        raise AssertionError(f"diagnose-sft rc={rc}, launches {counts} (want {want}), "
                             f"n_mcq {report['n_mcq']}, sx rows {len(rows)}, final_loss {loss}, "
                             f"rf_sft_spearman {rf_rho}, rf_blind_accuracy {rf_acc}")
    print(f"[train] diagnose-sft rc=0, {steps} steps x {k} folds, {chunks} scorer chunks; "
          f"launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as implied); "
          f"final_loss {loss:.4f}, blind_accuracy {report['blind_accuracy']:.4f}, "
          f"fold_accuracies {report['fold_accuracies']}; RF cross-check (rf.cross_check, the "
          f"default): rf_sft_spearman {rf_rho}, rf_blind_accuracy {rf_acc}, wall "
          f"{report['rf_cross_check_wall_seconds']} s; train {report['train_wall_seconds']} s "
          f"({report['train_samples_per_sec']} samples/s incl. the first step "
          f"{report['train_first_step_seconds']} s), scoring "
          f"{report['score_mcq_wall_seconds']} s, CLI wall {wall:.2f} s; peak device memory "
          f"{peak_gb:.2f} GB")

    # steady step time: the same state, one synchronized step at a time
    st = _train_state()
    lora, opt = st.lora, st.opt_state
    times = []
    for t in range(STEP_SAMPLES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, _ = st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                       st.answer_pos, st.batches[t])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    prof = _profile(lambda: st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                            st.answer_pos, st.batches[0]), 2)
    print(f"[train] step ({rows_per_step} rows of {st.tokens.shape[1]} tokens): median "
          f"{step_ms:.2f} ms over {STEP_SAMPLES} steps after the first "
          f"({rows_per_step / step_ms * 1e3:.1f} samples/s); first step {times[0] * 1e3:.1f} ms; "
          f"profile of one step: {_fmt_profile(prof)}; device time by op: "
          f"{'; '.join(prof['ops'])}")
    return counts


def _step_gates(kernel, plain):
    """One step's (per-fold losses, LoRA gradients) through the kernels
    against the plain path: the loss gap (fold_losses_agree), the per-leaf
    gradient cosines and their worst leaf, and whether both gates hold."""
    (loss_k, grads_k), (loss_p, grads_p) = kernel, plain
    cos = {f"{p}.{n}": torch.nn.functional.cosine_similarity(
               grads_k[p][n].float().flatten(), grads_p[p][n].float().flatten(), dim=0).item()
           for p in grads_k for n in grads_k[p]}
    gap, loss_ok = fold_losses_agree(loss_k.tolist(), loss_p.tolist())
    worst = min(cos, key=cos.get)
    line = (f"fold losses {loss_k.tolist()} vs plain {loss_p.tolist()} (max |d|/|loss| "
            f"{gap:.3e} <= {LOSS_RTOL}); LoRA gradient cosine min {cos[worst]:.5f} ({worst}) "
            f"over {len(cos)} leaves (>= {GRAD_COSINE})")
    return line, loss_ok and cos[worst] >= GRAD_COSINE


def phase_train_vs_plain():
    """One step's LoRA gradients through the kernels and through the plain
    attention, from the same seed: same weights, adapters and batch. B is
    drawn nonzero (it starts at 0, which leaves every A-gradient 0)."""
    states = {}
    for use_pallas in (True, False):
        st = _train_state([f"optim.batch_size={PLAIN_ROWS}",
                           f"model.use_pallas={str(use_pallas).lower()}"])
        rng = torch.Generator(device=st.tokens.device).manual_seed(7)
        for ab in st.lora.values():
            ab["b"] = (B_SCALE * torch.randn(ab["b"].shape, generator=rng,
                                          device=rng.device)).to(ab["b"].dtype)
        idx = torch.as_tensor(st.batches[0], dtype=torch.long, device=st.tokens.device)
        states[use_pallas] = st.trainer.loss_and_grads(
            st.params, st.lora, st.tokens[idx], st.loss_mask[idx], st.answer_pos[idx])
        del st
    line, ok = _step_gates(states[True], states[False])
    print(f"[train-vs-plain] {PLAIN_ROWS} rows per fold, kernels: {line}")
    if not ok:
        raise AssertionError("the train step through the kernels disagrees with the plain path")


def _seg_starts(b, s, seed):
    """int32 [b, MAX_SEGS] starts. At S <= 1024: starts inside 64-row tiles
    (1, 63, 64, 65 and near the end), a row of all SEG_PAD, one segment, a
    first start after 0, then random rows; longer: MAX_SEGS segments a row."""
    rng = np.random.default_rng(seed)
    fixed = [sorted({0, 1, 63, 64, 65, s // 2 + 1, max(s - 65, 0), s - 1}), [], [0], [7, 70]]
    rows = []
    for i in range(b):
        if s <= 1024 and i < len(fixed):
            starts = fixed[i][:MAX_SEGS]
        else:
            n = MAX_SEGS if s > 1024 else int(rng.integers(1, MAX_SEGS + 1))
            starts = [0] + sorted(rng.choice(np.arange(1, s), n - 1, replace=False).tolist())
        rows.append(starts + [SEG_PAD] * (MAX_SEGS - len(starts)))
    return np.asarray(rows, np.int32)


def _packed_step_starts():
    """The segment starts of the packed run's first train step, fold-major
    [k·B, MAX_SEGS], from the run's own state."""
    st = _train_state(PACKED)
    ka = np.arange(st.batches.shape[1])[:, None]
    seg = st.pack.seg_starts[ka, st.batches[0]]
    return seg.reshape(-1, seg.shape[-1])


def phase_kernel_seg(device):
    """The segmented kernels against their plain versions and autograd of
    the plain masked attention, at the packed train step's call (its own
    starts), Llama-3-8B heads at S=2048 with 8 segments, 128- and 64-token
    cases (SEG_SHAPES), each bit-equal on a second call; then times at the
    train step's shape."""
    import tst_torch.kernels.flash_attention as tfa

    cases = [(PACKED_TRAIN_SHAPE, _packed_step_starts())]
    cases += [(shape, _seg_starts(shape[0], shape[1], shape[1])) for shape in SEG_SHAPES]
    out = {}
    for (b, s, h, kvh, d), starts in cases:
        rng = np.random.default_rng(s + d + 2)
        q, do = (_randn(rng, (b, s, h, d), device) for _ in range(2))
        k, v = (_randn(rng, (b, s, kvh, d), device) for _ in range(2))
        seg = torch.from_numpy(starts).to(device)
        o, lse = tfa.flash_attention(q, k, v, seg_starts=seg)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention(q, k, v, seg_starts=seg), (o, lse),
                       "the segmented forward kernel")
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, seg_starts=seg)
        o_err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        del o_ref, lse_ref
        got = tfa.flash_attention_backward(q, k, v, o, lse, do, seg_starts=seg)
        torch.cuda.synchronize()
        _check_bitwise(lambda: tfa.flash_attention_backward(q, k, v, o, lse, do, seg_starts=seg),
                       got)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), seg_starts=seg)
        errs = [_rel_err(g, w) for g, w in zip(got, want)]
        abs_errs = [(g.float() - w).abs().max().item() for g, w in zip(got, want)]
        del want

        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ)
        tfa.flash_attention(*leaves, seg_starts=seg)[0].backward(do)
        if (tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ) != (before[0] + 1, before[1] + 1):
            raise AssertionError("the Function's backward did not launch both segmented kernels")
        plain = [t.detach().requires_grad_() for t in (q, k, v)]
        tfa.masked_attention(*plain, tfa.segment_mask(seg, s))[0].backward(do)
        torch.cuda.synchronize()
        auto_errs = [_rel_err(a.grad, p.grad) for a, p in zip(leaves, plain)]
        del leaves, plain
        finite = bool(torch.isfinite(o).all()) and all(
            bool(torch.isfinite(g).all()) and g.abs().max().item() > 0 for g in got)
        print(f"[kernel-seg] B={b} S={s} H={h} KVH={kvh} D={d}, "
              f"{int((starts < SEG_PAD).sum())} segment starts: max|o-ref| {o_err:.3e} "
              f"(<= {O_TOL}), max|lse-ref| {lse_err:.3e} (<= {LSE_TOL}); max|d-ref|/max|ref| "
              f"dq {errs[0]:.3e} dk {errs[1]:.3e} dv {errs[2]:.3e}; through autograd vs plain "
              f"masked attention dq {auto_errs[0]:.3e} dk {auto_errs[1]:.3e} "
              f"dv {auto_errs[2]:.3e} (each <= {GRAD_TOL})")
        if (not finite or o_err > O_TOL or lse_err > LSE_TOL
                or max(errs + auto_errs) > GRAD_TOL):
            raise AssertionError(f"segmented flash attention disagrees with its plain version "
                                 f"at {(b, s, h, kvh, d)}")
        if (b, s, h, kvh, d) == PACKED_TRAIN_SHAPE:
            out = _time_seg_kernels(q, k, v, do, seg, o, lse)
            out["fwd"]["max_abs_err"] = o_err
            out["dq"]["max_abs_err"], out["dkv"]["max_abs_err"] = abs_errs[0], abs_errs[1]
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    q = torch.zeros(2, 128, 4, 64, device=device, dtype=torch.bfloat16)
    kv = torch.zeros(2, 128, 2, 64, device=device, dtype=torch.bfloat16)
    good = torch.zeros(2, MAX_SEGS, dtype=torch.int32, device=device)
    for bad, causal in ((torch.zeros(2, MAX_SEGS + 1, dtype=torch.int32, device=device), True),
                        (good.long(), True), (good[:1], True), (good, False)):
        try:
            tfa.flash_attention(q, kv, kv, causal=causal, seg_starts=bad)
        except ValueError:
            continue
        raise AssertionError(f"flash_attention accepted seg_starts {tuple(bad.shape)} "
                             f"{bad.dtype} causal={causal}")
    f, dkv, dq, lib = out["fwd"], out["dkv"], out["dq"], out.pop("library")
    print(f"[kernel-seg] bit-equal on a second call at every shape; bad starts rejected (9 "
          f"columns, int64, wrong batch, causal=False); train shape {PACKED_TRAIN_SHAPE}: "
          f"forward segmented {f['ms']:.4f} ms (bound {f['bound_ms']:.4f}, {f['bound_by']}), "
          f"unsegmented {f['unsegmented_ms']:.4f} ms, plain {f['plain_ms']:.4f} ms; dK/dV "
          f"segmented {dkv['ms']:.4f} ms (bound {dkv['bound_ms']:.4f}, {dkv['bound_by']}), "
          f"unsegmented {dkv['unsegmented_ms']:.4f} ms; dQ segmented {dq['ms']:.4f} ms (bound "
          f"{dq['bound_ms']:.4f}, {dq['bound_by']}), unsegmented {dq['unsegmented_ms']:.4f} ms; "
          f"plain backward {dq['plain_ms']:.4f} ms; scaled_dot_product_attention with the "
          f"segment mask ({lib['backend']}, {lib['gqa']}; max|o-o_kernel| "
          f"{lib['max_abs_o_diff']:.3e}): forward {lib['fwd_ms']:.4f} ms, backward alone "
          f"{lib['bwd_ms']:.4f} ms (kernels and library: median of 30 x 10 calls; plain: 10 x 3)")
    return out


def _time_seg_kernels(q, k, v, do, seg, o, lse):
    """Median times of the segmented kernels, the unsegmented ones at the
    same shape, and the plain versions (segment-masked)."""
    import tst_torch.kernels.flash_attention as tfa

    kseg = tfa.kernel_seg_starts(seg, q)
    di = tfa.backward_row_stat(o, do)
    o_u, lse_u = tfa.flash_attention(q, k, v)
    di_u = tfa.backward_row_stat(o_u, do)
    plain_bwd = median_ms(lambda: tfa.flash_attention_backward_reference(
        q, k, v, o, lse, do, seg_starts=seg), samples=10, reps=3, warmup=1)
    lib = _sdpa_yardstick(q, k, v, do, o, tfa.segment_mask(seg, q.shape[1]))
    bounds = _attention_bounds(q, k, seg)
    return {
        "fwd": {"ms": median_ms(lambda: tfa._launch_fwd(q, k, v, kseg)),
                "unsegmented_ms": median_ms(lambda: tfa._launch_fwd(q, k, v)),
                "plain_ms": median_ms(lambda: tfa.flash_attention_reference(
                    q, k, v, seg_starts=seg), samples=10, reps=3, warmup=1),
                "library_ms": lib["fwd_ms"], **bounds["fwd"]},
        "dkv": {"ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di, kseg)),
                "unsegmented_ms": median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse_u, di_u)),
                "plain_ms": plain_bwd, "library_ms": lib["bwd_ms"], **bounds["dkv"]},
        "dq": {"ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di, kseg)),
               "unsegmented_ms": median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse_u, di_u)),
               "plain_ms": plain_bwd, "library_ms": lib["bwd_ms"], **bounds["dq"]},
        "library": lib,
    }


def phase_train_packed():
    from tst_torch import cli
    from tst_torch.train.infer import pack_heldout_mcq, packed_scorer_batch

    out_dir = tempfile.mkdtemp(prefix="tst_torch_packed_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(TRAIN + ["--set", PACKED[0], "--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "sx.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    st = _train_state(PACKED)
    k, steps = report["k"], report["train_steps"]
    batch = packed_scorer_batch(st.pack.pack_len)
    held_out_rows = pack_heldout_mcq(st.tb, st.fold_id, k, st.pack.pack_len, batch)[0].shape[1]
    chunks = k * held_out_rows // batch
    want = {"fwd": 0, "dkv": 0, "dq": 0, "fwd_seg": N_LAYERS * (steps + chunks),
            "dkv_seg": N_LAYERS * steps, "dq_seg": N_LAYERS * steps, "int4": 0, "mlp": 0}
    loss = report["final_loss"]
    sx = np.array([r["s_x"] for r in rows], np.float64)
    if (rc != 0 or counts != want or report.get("pack_len") != 1024
            or "pack_fill_fraction" not in report or report["n_mcq"] != N_SAMPLES
            or len(rows) != N_SAMPLES or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()):
        raise AssertionError(f"packed diagnose-sft rc={rc}, launches {counts} (want {want}), "
                             f"pack_len {report.get('pack_len')}, n_mcq {report['n_mcq']}, "
                             f"sx rows {len(rows)}, final_loss {loss}")
    print(f"[train-packed] diagnose-sft optim.pack=true rc=0, pack_len {report['pack_len']}, "
          f"fill {report['pack_fill_fraction']}, packed rows per fold "
          f"{st.pack.n_rows.tolist()}; {steps} steps x {k} folds, {chunks} scorer chunks of "
          f"{batch} rows; segmented launches fwd {counts['fwd_seg']} dkv {counts['dkv_seg']} "
          f"dq {counts['dq_seg']}, unsegmented 0 (as implied); final_loss {loss:.4f}, "
          f"blind_accuracy {report['blind_accuracy']:.4f}, fold_accuracies "
          f"{report['fold_accuracies']}; train {report['train_wall_seconds']} s "
          f"({report['train_samples_per_sec']} samples/s incl. the first step "
          f"{report['train_first_step_seconds']} s), scoring {report['score_mcq_wall_seconds']} s, "
          f"CLI wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB")

    # steady step time: the same state, one synchronized step at a time
    lora, opt = st.lora, st.opt_state
    times = []
    for t in range(STEP_SAMPLES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, _ = st.trainer.step(st.params, lora, opt, st.ptokens, st.pmask, st.ppos,
                                       st.batches[t], st.psegs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_ms = statistics.median(times[1:]) * 1e3
    ka = np.arange(st.batches.shape[1])[:, None]
    samples = float(np.mean([st.pack.n_segs[ka, st.batches[t]].sum()
                             for t in range(1, STEP_SAMPLES + 1)]))
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    prof = _profile(lambda: st.trainer.step(st.params, lora, opt, st.ptokens, st.pmask, st.ppos,
                                            st.batches[0], st.psegs), 2)
    print(f"[train-packed] step ({rows_per_step} packed rows of {st.ptokens.shape[-1]} tokens, "
          f"{samples:.1f} samples on average): median {step_ms:.2f} ms over {STEP_SAMPLES} "
          f"steps after the first ({samples / step_ms * 1e3:.1f} train samples/s); first step "
          f"{times[0] * 1e3:.1f} ms; profile of one step: {_fmt_profile(prof)}; device time by "
          f"op: {'; '.join(prof['ops'])}")
    return counts


def phase_train_packed_vs_plain():
    """One packed step's LoRA gradients and losses, and the packed scorer's
    letter probabilities, through the kernels and through the plain path
    from the same seed: same weights, adapters (B drawn nonzero) and rows."""
    from tst_torch.train.infer import score_heldout_mcq_packed

    grads, probs, secs = {}, {}, {}
    for use_pallas in (True, False):
        st = _train_state(PACKED + [f"optim.batch_size={PACKED_PLAIN_ROWS}",
                                    f"model.use_pallas={str(use_pallas).lower()}"])
        rng = torch.Generator(device=st.tokens.device).manual_seed(7)
        for ab in st.lora.values():
            ab["b"] = (B_SCALE * torch.randn(ab["b"].shape, generator=rng,
                                          device=rng.device)).to(ab["b"].dtype)
        idx = torch.as_tensor(st.batches[0], dtype=torch.long, device=st.tokens.device)
        idx = (torch.arange(idx.shape[0], device=idx.device)[:, None], idx)
        grads[use_pallas] = st.trainer.loss_and_grads(
            st.params, st.lora, st.ptokens[idx], st.pmask[idx], st.ppos[idx], st.psegs[idx])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        probs[use_pallas] = score_heldout_mcq_packed(
            st.params, st.lora, st.spec, st.lspec, st.tb, st.fold_id, st.trainer.k,
            pack_len=st.pack.pack_len, use_pallas=use_pallas)
        secs[use_pallas] = time.perf_counter() - t0
        gold = st.tb.gold
        del st
        torch.cuda.empty_cache()
    line, ok = _step_gates(grads[True], grads[False])
    pk, pp = probs[True], probs[False]
    diff = float(np.abs(pk - pp).max())
    agree = float((pk.argmax(-1) == pp.argmax(-1)).mean())
    print(f"[train-packed-vs-plain] {PACKED_PLAIN_ROWS} packed rows per fold, kernels: {line}; "
          f"packed scorer letter probabilities max|dprob| "
          f"{diff:.3e} (<= {PROB_TOL}), argmax agreement {agree:.4f} (>= {ARGMAX_AGREE}), "
          f"accuracy {float((pk.argmax(-1) == gold).mean()):.4f}; scoring {secs[True]:.3f} s "
          f"kernel, {secs[False]:.3f} s plain")
    if (not ok or pk.shape != (N_SAMPLES, 4)
            or not np.isfinite(pk).all() or diff > PROB_TOL or agree < ARGMAX_AGREE):
        raise AssertionError("the packed path through the kernels disagrees with the plain path")


def _profile(fn, steps, match=None):
    """Per call of ``fn``: the synchronized wall ms of ``steps`` calls
    without the profiler, and the device's busy ms from a torch.profiler
    trace of ``steps`` more (the sum of kernel times); the idle share is
    1 - busy / wall. The profiler's own host cost stays out of the wall: a
    launch-bound loop runs several times slower under it. Also the five
    kernels that take the most device time, with their launches per call,
    the twelve host ops whose launches take the most device time (a
    hand-written kernel counts under the op that launched it), and the
    device ms and launches of the kernels whose names hold ``match``. Busy
    and idle are None where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    kernels, ops = [], []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        row = (us / 1e3 / steps, e.count / steps, e.key)
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append(row)
        elif us > 0:
            ops.append(row)
    busy = sum(k[0] for k in kernels)
    if busy <= 0:
        return {"wall_ms": wall_ms, "busy_ms": None, "idle_share": None, "top": [], "ops": []}
    top = [f"{name[:60]} {ms:.3f} ms x{cnt:g}" for ms, cnt, name in sorted(kernels)[::-1][:5]]
    by_op = [f"{name[:48]} {ms:.3f} ms ({ms / busy:.1%})" for ms, _, name in sorted(ops)[::-1][:12]]
    out = {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms, "top": top,
           "ops": by_op}
    if match:
        mine = [(ms, cnt) for ms, cnt, name in kernels if match in name]
        out["match"] = (match, sum(ms for ms, _ in mine), sum(cnt for _, cnt in mine))
    return out


def _fmt_profile(p):
    if p["busy_ms"] is None:
        return f"wall {p['wall_ms']:.3f} ms; device time not measured (no kernel time in trace)"
    line = (f"wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}")
    if "match" in p:
        name, ms, cnt = p["match"]
        line += (f"; kernels named {name}: {ms:.3f} ms in {cnt:g} launches, "
                 f"{ms / p['busy_ms']:.1%} of busy")
    return line + f"; top kernels: {'; '.join(p['top'])}"


def _capture(fn, calls=1, keep=False):
    """A CUDA graph of ``calls`` calls of ``fn``, after one call on a side
    stream has bound the entries and warmed the allocator outside the
    capture; ``keep`` keeps the graph for libcuda's graph API."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=keep)
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    return graph


def graph_us(fn, calls=10, replays=20):
    """Device µs a call of ``fn``, without the host: ``calls`` calls captured
    in one CUDA graph, the median over ``replays`` CUDA-event timings of a
    replay, per call."""
    graph = _capture(fn, calls)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls * 1e3)
    return statistics.median(times)


def graph_kernels(fn):
    """Kernel launches a call of ``fn``: the kernel nodes of a CUDA graph
    captured around one call, counted through libcuda's graph API (the profiler
    can drop kernel events, so it is no gate)."""
    graph = _capture(fn, keep=True)
    libcuda = ctypes.CDLL("libcuda.so.1")
    raw, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    if libcuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if libcuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kind, kernels = ctypes.c_int(), 0
    for node in nodes:
        if libcuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def host_us(fn, calls=300):
    """Host µs a call of ``fn``: ``calls`` calls back to back, no
    synchronization inside the timed loop (the device, faster a call than the
    host here, keeps up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall / calls * 1e6


def phase_kernel_int4(device, strict=True):
    """K3 against its plain version at decode's M for every int4 leaf of
    Qwen2.5-0.5B and Llama-3-8B (layer 1 of a 2-layer stack, weights drawn in
    bf16 and quantized as the model's are), bit-equal on a second call; at
    every Qwen shape its device time a call (CUDA graph), its host time a
    call (the public entry) and the plain version's time; one kernel a call
    (``strict``: else only printed, for a parent tree)."""
    import tst_torch.kernels.quant_matmul as tqm
    from tst_torch.models.quant import quantize_leaf

    g = torch.Generator(device=device).manual_seed(11)
    layer = {m: {"device_us": 0.0, "host_us": 0.0, "plain_ms": 0.0} for m in INT4_M}
    worst, timed = 0.0, []
    cases = [(name, k, n) for name, (k, n) in QWEN_INT4.items()]
    cases += [("llama3-8b", k, n) for k, n in LLAMA_INT4]
    for name, k, n in cases:
        w = (torch.randn(2, k, n, device=device, generator=g) / math.sqrt(k)).to(torch.bfloat16)
        leaf = quantize_leaf(w, bits=4)
        q, sc = leaf["q"], leaf["scale"]
        del w, leaf
        for m in INT4_M:
            y = torch.randn(m, k, device=device, generator=g).to(torch.bfloat16)
            before = tqm.LAUNCHES
            got = tqm.int4_matmul_stacked(y, q, sc, 1)
            torch.cuda.synchronize()
            want = tqm.int4_matmul_reference(y, q, sc, 1)
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            if (tqm.LAUNCHES != before + 1 or rel > INT4_TOL
                    or not bool(torch.isfinite(got).all())):
                raise AssertionError(f"int4_matmul disagrees with its plain version at "
                                     f"M={m} K={k} N={n}: max|d|/max|ref| {rel:.3e}")
            _check_bitwise(lambda: (tqm.int4_matmul_stacked(y, q, sc, 1),), (got,), "K3")
            worst = max(worst, err)
            line = f"[kernel-int4] {name} M={m} K={k} N={n}: max|out-ref|/max|ref| {rel:.3e}"
            if name in QWEN_INT4:
                timed.append((y, q, sc))
                dev = graph_us(lambda: tqm._launch(y, q, sc, 1))
                host = host_us(lambda: tqm.int4_matmul_stacked(y, q, sc, 1))
                plain = median_ms(lambda: tqm.int4_matmul_reference(y, q, sc, 1))
                layer[m]["device_us"] += dev
                layer[m]["host_us"] += host
                layer[m]["plain_ms"] += plain
                line += (f"; kernel {dev:.2f} µs on the device, {host:.2f} µs on the host; "
                         f"plain {plain:.4f} ms")
            print(line + f" (<= {INT4_TOL})")
        del q, sc
    # kernels a call: a CUDA graph of one call at every Qwen shape
    launches = graph_kernels(lambda: [tqm._launch(y, q, sc, 1) for y, q, sc in timed]) / len(timed)
    del timed
    print(f"[kernel-int4] bit-equal on a second call at every shape; kernels a call: "
          f"{launches:g}")
    if strict and launches != 1:
        raise AssertionError(f"K3 must be one launch a call: {launches:g}")
    for m in INT4_M:
        print(f"[kernel-int4] one decode layer's 7 projections at M={m}: device "
              f"{layer[m]['device_us']:.2f} µs (CUDA graph of 10 calls, median of 20 replays), "
              f"host {layer[m]['host_us']:.2f} µs (300 calls back to back), plain (dequantize, "
              f"then product) {layer[m]['plain_ms']:.4f} ms (sums over the projections)")
    # a layer's seven projections at M=32: y, packed weights and f32 scales in, f32 out
    m = INT4_M[0]
    flops = sum(2 * m * k * n for k, n in QWEN_INT4.values())
    nbytes = sum(m * k * 2 + k * n // 2 + (k // 128) * n * 4 + m * n * 4
                 for k, n in QWEN_INT4.values())
    return {"max_abs_err": worst, "ms": layer[m]["device_us"] / 1e3,
            "plain_ms": layer[m]["plain_ms"], "library_ms": None, **_bound(flops, nbytes),
            "host_ms": layer[m]["host_us"] / 1e3,
            "device_us_a_call": {str(mm): layer[mm]["device_us"] / INT4_PROJ for mm in INT4_M},
            "host_us_a_call": {str(mm): layer[mm]["host_us"] / INT4_PROJ for mm in INT4_M},
            "timed": f"device time summed over one Qwen2.5-0.5B layer's 7 projections at M={m} "
                     f"(CUDA graph); host_ms the same sum on the host"}


def phase_kernel_mlp(device):
    """K4 against its plain version and the decoder's unfused bf16 MLP,
    bit-equal on a second call; gradients of all four inputs through the
    autograd Function against autograd of the plain version; times at the
    train step's shape, each kernel's on its own."""
    import tst_torch.kernels.fused_mlp as tfm

    out = {}
    for m, d, f in MLP_SHAPES:
        g = torch.Generator(device=device).manual_seed(m + d)
        x = torch.randn(m, d, device=device, generator=g).to(torch.bfloat16)
        wg, wu = ((torch.randn(d, f, device=device, generator=g) / math.sqrt(d))
                  .to(torch.bfloat16) for _ in range(2))
        wd = (torch.randn(f, d, device=device, generator=g) / math.sqrt(f)).to(torch.bfloat16)
        dout = torch.randn(m, d, device=device, generator=g).to(torch.bfloat16)
        before = tfm.LAUNCHES
        got = tfm.fused_mlp_forward(x, wg, wu, wd)
        torch.cuda.synchronize()
        want = tfm.swiglu_reference(x, wg, wu, wd)
        fwd_rel = _rel_err(got, want)
        fwd_abs = (got.float() - want.float()).abs().max().item()
        leaves = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
        tfm.fused_swiglu_mlp(*leaves).backward(dout)
        plain = [t.detach().requires_grad_() for t in (x, wg, wu, wd)]
        tfm.swiglu_reference(*plain).backward(dout)
        torch.cuda.synchronize()
        grad_rel = [_rel_err(a.grad, p.grad) for a, p in zip(leaves, plain)]
        del leaves, plain
        print(f"[kernel-mlp] M={m} D={d} F={f}: forward max|out-ref|/max|ref| {fwd_rel:.3e}; "
              f"through autograd vs plain dx {grad_rel[0]:.3e} dWg {grad_rel[1]:.3e} "
              f"dWu {grad_rel[2]:.3e} dWd {grad_rel[3]:.3e} (each <= {MLP_TOL})")
        if (tfm.LAUNCHES != before + 2 or not bool(torch.isfinite(got).all())
                or max([fwd_rel] + grad_rel) > MLP_TOL):
            raise AssertionError(f"fused_swiglu_mlp disagrees with its plain version at "
                                 f"{(m, d, f)}")
        _check_bitwise(lambda: (tfm.fused_mlp_forward(x, wg, wu, wd),), (got,), "K4")
        if (m, d, f) == MLP_SHAPES[0]:
            def unfused():
                act = torch.nn.functional.silu((x @ wg).float()).to(x.dtype) * (x @ wu)
                return act @ wd

            by_kernel = None  # a tree with one K4 kernel: the call is the kernel
            if hasattr(tfm, "_gate_up"):
                h = tfm._gate_up(x, wg, wu)
                by_kernel = {K4_KERNELS[0]: median_ms(lambda: tfm._gate_up(x, wg, wu)),
                             K4_KERNELS[1]: median_ms(lambda: tfm._down(h, wd))}
                del h
            out = {"max_abs_err": fwd_abs, "ms": median_ms(lambda: tfm._launch(x, wg, wu, wd)),
                   "plain_ms": median_ms(lambda: tfm.swiglu_reference(x, wg, wu, wd),
                                         samples=10, reps=3, warmup=1),
                   "library_ms": None,  # no single torch call computes the fused MLP
                   "unfused_bf16_ms": median_ms(unfused, samples=10, reps=3, warmup=1),
                   "kernels_ms": by_kernel,
                   **_bound(3 * 2 * m * d * f, 2 * m * d * 2 + 3 * d * f * 2)}
        del x, wg, wu, wd, dout, got, want
        torch.cuda.empty_cache()
    m, d, f = MLP_SHAPES[0]

    def tflops(name, ms):  # gate-up makes two products of the three
        share = 2 if "gate_up" in name else 1 if "down" in name else 3
        return 2 * share * m * d * f / ms / 1e9

    kernels = "; ".join(f"{name} {ms:.4f} ms ({tflops(name, ms):.1f} TFLOP/s)"
                        for name, ms in (out["kernels_ms"] or {}).items()) or "one kernel"
    print(f"[kernel-mlp] bit-equal on a second call at every shape; train shape {MLP_SHAPES[0]}: "
          f"call {out['ms']:.4f} ms ({tflops('', out['ms']):.1f} TFLOP/s; median of 30 x 10 "
          f"calls); by kernel (the same): {kernels}; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}); plain (f32 products, the reference's numbers) "
          f"{out['plain_ms']:.4f} ms, the decoder's unfused bf16 MLP "
          f"{out['unfused_bf16_ms']:.4f} ms (10 x 3)")
    return out


def _numeric_rows(ds):
    from tst_torch.train.pipeline import gold_values_of

    return np.flatnonzero(np.isfinite(gold_values_of(ds)))


def _decode_chunks(spec, params, seq_len, fold_of_rows, k):
    """(rows per fold of a decode chunk, decode chunks) as the held-out
    decode sizes them for these rows."""
    from tst_torch.models.quant import quantized_bytes
    from tst_torch.train.infer import decode_chunk_rows

    m = max(int((fold_of_rows == f).sum()) for f in range(k))
    chunk = decode_chunk_rows(spec, seq_len, MAX_NEW, k, base_bytes=quantized_bytes(params))
    mc = min(m, chunk)
    return mc, math.ceil(m / mc)


def phase_decode_slice():
    """Path A through the CLI, then K3 against the plain path on the same
    weights and caches, decode step times and a profile of the step."""
    from tst_torch import cli
    from tst_torch.models.decode import chunk_logits, greedy_decode, prefill
    from tst_torch.train.pipeline import prepare_blind_eval

    out_dir = tempfile.mkdtemp(prefix="tst_torch_decode_")
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(DECODE + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    with open(os.path.join(out_dir, "blind_eval.json")) as f:
        report = json.load(f)
    cfg, device = cli._resolve(cli.build_parser().parse_args(DECODE))
    ds = cli._load_dataset(cfg)
    tb, tokens, pos, spec, params = prepare_blind_eval(ds, cfg, device)
    rows = _numeric_rows(ds)
    mc, dchunks = _decode_chunks(spec, params, tokens.shape[1], np.zeros(len(rows)), 1)
    mcq_chunks = math.ceil(N_SAMPLES / SCORER_BATCH)
    want = {"fwd": N_LAYERS * (mcq_chunks + dchunks), "dkv": 0, "dq": 0, "fwd_seg": 0,
            "dkv_seg": 0, "dq_seg": 0, "int4": INT4_PROJ * N_LAYERS * (MAX_NEW - 1) * dchunks,
            "mlp": 0}
    mra = report.get("numeric_blind_mra")
    if (rc != 0 or counts != want or report.get("n_numeric") != N_NUMERIC_VSI
            or report["n_mcq"] != N_MCQ_VSI or mra is None or not math.isfinite(mra)):
        raise AssertionError(f"eval-blind int4 rc={rc}, launches {counts} (want {want}), "
                             f"report {report}")
    print(f"[decode-slice] eval-blind synthetic-vsi:0.4 int4 rc=0: n_mcq {report['n_mcq']}, "
          f"n_numeric {report['n_numeric']} in {dchunks} decode chunks of {mc} rows x "
          f"{MAX_NEW} tokens; launches fwd {counts['fwd']} (24 x ({mcq_chunks} MCQ + {dchunks} "
          f"prefill chunks)), int4 {counts['int4']} (7 x 24 x {MAX_NEW - 1} steps x {dchunks}), "
          f"mlp/dkv/dq 0 (as implied); blind_accuracy {report['blind_accuracy']:.4f}, "
          f"numeric_blind_mra {mra}; CLI wall {wall:.2f} s")

    # the first decode step of every numeric row, chunk by chunk, on the same
    # weights and caches: K3 vs plain
    rels, differ, decisive, whole, per_tok, gaps = [], 0, 0, 0, 0.0, []
    for c0 in range(0, len(rows), DECODE_ROWS):
        sel = torch.as_tensor(rows[c0: c0 + DECODE_ROWS], device=device)
        tok, plen = tokens[sel], pos[sel].long() + 1
        s = tok.shape[1]
        with torch.inference_mode():
            tok0, kc, vc, head, rope = prefill(params, tok, plen, MAX_NEW, spec, use_pallas=True)
            valid = torch.arange(kc.shape[2], device=device)[None, :] < plen[:, None]
            lk, lp = (chunk_logits(params, None, None, spec, tok0[:, None], plen[:, None], s,
                                   valid, kc.clone(), vc.clone(), use_pallas=up, head=head,
                                   rope=rope)[0][:, 0] for up in (True, False))
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError("non-finite logits through K3")
        rels.append(((lk - lp).abs().max() / lp.abs().max()).item())
        n_differ, n_decisive, chunk_gaps = decisive_disagreements(lk, lp)
        differ, decisive, gaps = differ + n_differ, decisive + n_decisive, gaps + chunk_gaps
        gen_k, gen_p = (greedy_decode(params, tok, plen, MAX_NEW, spec, use_pallas=up)
                        for up in (True, False))
        whole += int((gen_k == gen_p).all(-1).sum().item())
        per_tok += (gen_k == gen_p).float().sum().item() / MAX_NEW
    print(f"[decode-slice] first decode step of the {len(rows)} numeric rows ({DECODE_ROWS} a "
          f"chunk), same caches: K3 vs plain max|dlogit|/max|logit| {max(rels):.3e} "
          f"(<= {LOGIT_TOL}); argmax disagreements {differ} of {len(rows)} (the plain path's "
          f"top-2 gap on each: {[round(g, 4) for g in gaps]}), decisive (gap > 2 x {LOGIT_TOL} "
          f"x max|logit|) {decisive} (must be 0); greedy continuations ({MAX_NEW} tokens): "
          f"whole-row agreement {whole / len(rows):.4f}, per-token {per_tok / len(rows):.4f}")
    if max(rels) > LOGIT_TOL or decisive:
        raise AssertionError("the decode step through K3 disagrees with the plain path")

    # step times and the device's idle share in the step
    step = decode_step_profiles((params, spec, tok0, plen, s, kc, vc, head, rope))
    for up, name in ((True, "through K3"), (False, "plain path (dequantize, then product)")):
        print(f"[decode-slice] decode step ({DECODE_ROWS} rows, 24 layers), {name}: "
              f"{DECODE_ROWS / step[up]['wall_ms'] * 1e3:.1f} tokens/s; "
              f"{_fmt_profile(step[up])}")
    return counts


def decode_state():
    """Phase 13's model and the caches of its first chunk of numeric rows
    after the prefill: the state one greedy decode step runs on."""
    from tst_torch import cli
    from tst_torch.models.decode import prefill
    from tst_torch.train.pipeline import prepare_blind_eval

    cfg, device = cli._resolve(cli.build_parser().parse_args(DECODE))
    ds = cli._load_dataset(cfg)
    _, tokens, pos, spec, params = prepare_blind_eval(ds, cfg, device)
    sel = torch.as_tensor(_numeric_rows(ds)[:DECODE_ROWS], device=device)
    tok, plen = tokens[sel], pos[sel].long() + 1
    with torch.inference_mode():
        tok0, kc, vc, head, rope = prefill(params, tok, plen, MAX_NEW, spec, use_pallas=True)
    return params, spec, tok0, plen, tok.shape[1], kc, vc, head, rope


def decode_step_profiles(state, steps=10):
    """One greedy decode step through K3 and through the plain path on
    ``state`` (decode_state): _profile of each, K3's kernels matched."""
    from tst_torch.models.decode import _decode_step

    params, spec, tok0, plen, s, kc, vc, head, rope = state
    step = {}
    with torch.inference_mode():
        for up in (True, False):
            def one(up=up):
                _decode_step(params, None, None, spec, tok0, plen, s, plen, s, kc, vc,
                             use_pallas=up, head=head, rope=rope)
            step[up] = _profile(one, steps, match="int4_matmul")
    return step


def step_timing(st, match="swiglu"):
    """A train state's median synchronized step ms over STEP_SAMPLES steps
    after the first, the peak device memory over them, and _profile of two
    more steps (kernels named ``match`` counted)."""
    lora, opt = st.lora, st.opt_state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for t in range(STEP_SAMPLES + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lora, opt, _ = st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                       st.answer_pos, st.batches[t])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = _profile(lambda: st.trainer.step(st.params, lora, opt, st.tokens, st.loss_mask,
                                            st.answer_pos, st.batches[0]), 2, match=match)
    return statistics.median(times[1:]) * 1e3, peak, prof


def phase_steps():
    """For --only mlp-int4: the int4 decode step through K3 (phase 13's
    profile) and the fused int4 train step (phase 14's timing)."""
    step = decode_step_profiles(decode_state())[True]
    print(f"[steps] int4 decode step ({DECODE_ROWS} rows, 24 layers) through K3: "
          f"{_fmt_profile(step)}")
    ms, peak, prof = step_timing(_train_state(base=TRAIN_FUSED))
    print(f"[steps] int4 train step fused (K4): median {ms:.2f} ms over {STEP_SAMPLES} steps "
          f"after the first, peak device memory {peak:.2f} GB; profile of one step: "
          f"{_fmt_profile(prof)}")
    return {"decode_step_wall_ms": step["wall_ms"], "decode_step_busy_ms": step["busy_ms"],
            "decode_step_k3_ms": step.get("match", (None, None))[1],
            "fused_step_ms": ms, "fused_step_peak_gb": peak, "fused_step_busy_ms": prof["busy_ms"],
            "fused_step_k4_ms": prof.get("match", (None, None))[1]}


def phase_train_fused():
    """Path B through the CLI; one step's gradients fused vs the unfused
    plain path; step times fused vs unfused, peak memory, a profile."""
    from tst_torch import cli

    out_dir = tempfile.mkdtemp(prefix="tst_torch_fused_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(TRAIN_FUSED + ["--out", out_dir])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    with open(os.path.join(out_dir, "sx.jsonl")) as f:
        sx_rows = [json.loads(line) for line in f]
    st = _train_state(base=TRAIN_FUSED)
    cfg, _ = cli._resolve(cli.build_parser().parse_args(TRAIN_FUSED))
    rows = _numeric_rows(cli._load_dataset(cfg))
    k, steps = report["k"], report["train_steps"]
    mcq_fold = np.where(st.tb.gold >= 0, st.fold_id, -1)
    chunks = k * math.ceil(max(int((mcq_fold == f).sum()) for f in range(k)) / SCORER_BATCH)
    mc, dchunks = _decode_chunks(st.spec, st.params, st.tokens.shape[1], st.fold_id[rows], k)
    want = {"fwd": N_LAYERS * (steps + chunks + dchunks), "dkv": N_LAYERS * steps,
            "dq": N_LAYERS * steps, "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0,
            "int4": INT4_PROJ * N_LAYERS * (MAX_NEW - 1) * dchunks, "mlp": N_LAYERS * steps}
    loss = report["final_loss"]
    sx = np.array([r["s_x"] for r in sx_rows], np.float64)
    mra = report.get("numeric_blind_mra")
    if (rc != 0 or counts != want or report.get("n_numeric") != N_NUMERIC_VSI
            or report["n_mcq"] != N_MCQ_VSI or len(sx_rows) != N_SAMPLES
            or "numeric_decode_wall_seconds" not in report or mra is None
            or not math.isfinite(mra) or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()):
        raise AssertionError(f"diagnose-sft int4 fused rc={rc}, launches {counts} "
                             f"(want {want}), report {report}")
    print(f"[train-fused] diagnose-sft int4 fused_mlp rc=0, {steps} steps x {k} folds, "
          f"{chunks} scorer chunks, {dchunks} decode chunks of {k} x {mc} rows; launches "
          f"mlp {counts['mlp']} fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} "
          f"int4 {counts['int4']} (as implied); CLI wall {wall:.2f} s; peak device memory "
          f"{peak_gb:.2f} GB")
    print(f"[train-fused] report.json {json.dumps(report, sort_keys=True)}")
    top = sorted(sx_rows, key=lambda r: -r["s_x"])[:5]
    print(f"[train-fused] s(x) table: {len(sx_rows)} rows, mean {sx.mean():.4f}, quantiles "
          f"10/50/90% {np.quantile(sx, [0.1, 0.5, 0.9]).round(4).tolist()}; top 5 "
          f"{json.dumps(top)}")

    # one step, fused through the kernels vs the unfused plain path
    states = {}
    for fused in (True, False):
        over = [f"optim.batch_size={PLAIN_ROWS}"] + ([] if fused else ["model.use_pallas=false"])
        st2 = _train_state(over, base=TRAIN_FUSED)
        rng = torch.Generator(device=st2.tokens.device).manual_seed(7)
        for ab in st2.lora.values():
            ab["b"] = (B_SCALE * torch.randn(ab["b"].shape, generator=rng,
                                          device=rng.device)).to(ab["b"].dtype)
        idx = torch.as_tensor(st2.batches[0], dtype=torch.long, device=st2.tokens.device)
        states[fused] = st2.trainer.loss_and_grads(
            st2.params, st2.lora, st2.tokens[idx], st2.loss_mask[idx], st2.answer_pos[idx])
        del st2
    line, ok = _step_gates(states[True], states[False])
    print(f"[train-fused] {PLAIN_ROWS} rows per fold, fused kernels vs unfused plain path: "
          f"{line}")
    if not ok:
        raise AssertionError("the fused train step disagrees with the unfused plain path")
    del states

    # step times fused vs unfused (both int4, flash kernels), peak memory
    timing = {True: step_timing(st)}
    st2 = _train_state(["model.fused_mlp=false"], base=TRAIN_FUSED)
    timing[False] = step_timing(st2)
    del st2
    torch.cuda.empty_cache()
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    for fused, name in ((True, "fused (K4)"), (False, "unfused")):
        ms, peak, prof = timing[fused]
        print(f"[train-fused] int4 step {name} ({rows_per_step} rows of {st.tokens.shape[1]} "
              f"tokens): median {ms:.2f} ms over {STEP_SAMPLES} steps after the first "
              f"({rows_per_step / ms * 1e3:.1f} samples/s), peak device memory {peak:.2f} GB; "
              f"profile of one step: {_fmt_profile(prof)}")
    return counts


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def phase_diagnose_rf(device):
    """``diagnose-rf`` through the CLI, the forests traversed on the card:
    each fold's forest traversed again on the host path (the same trees,
    f64 thresholds) gives the same probabilities and the same s(x) ranking;
    no kernel runs; the planted length bias lifts blind accuracy above
    chance. The fit's wall, and the traversal's time on the card and on the
    host."""
    from tst_torch import cli
    from tst_torch.diagnose.score import bias_scores
    from tst_torch.features import forest as tforest

    folds = []
    fit, full = tforest.RandomForest.fit, tforest.RandomForest.predict_proba_full

    def timed_fit(self, x, y):
        t0 = time.perf_counter()
        out = fit(self, x, y)
        folds.append({"fit_s": time.perf_counter() - t0, "n_train": len(y)})
        return out

    def recorded(self, x, n_classes, backend="jax"):
        probs = full(self, x, n_classes, backend)
        folds[-1].update(forest=self, x=x, n_classes=n_classes, backend=backend, probs=probs)
        return probs

    out_dir = tempfile.mkdtemp(prefix="tst_torch_rf_")
    _zero_launch_counts()
    tforest.RandomForest.fit, tforest.RandomForest.predict_proba_full = timed_fit, recorded
    try:
        t0 = time.perf_counter()
        rc = cli.main(RF + ["--out", out_dir])
        wall = time.perf_counter() - t0
    finally:
        tforest.RandomForest.fit, tforest.RandomForest.predict_proba_full = fit, full
    counts = _launch_counts()
    with open(os.path.join(out_dir, "report.json")) as f:
        report = json.load(f)
    rows = _read_jsonl(os.path.join(out_dir, "sx.jsonl"))
    cfg, _ = cli._resolve_k(cli.build_parser().parse_args(RF))
    ds = cli._load_dataset(cfg)
    gold = np.array([s.answer_index for s in ds], np.int32)
    n_opts = np.array([len(s.options) for s in ds], np.int32)
    fold = np.array([r["fold"] for r in rows])
    s_dev = np.array([np.nan if r["s_x"] is None else r["s_x"] for r in rows], np.float64)
    probs_host = np.full((len(ds), folds[0]["n_classes"]), np.nan, np.float32)
    err, host_s = 0.0, 0.0
    for f, rec in enumerate(folds):
        forest = rec["forest"]
        if rec["backend"] != "jax" or forest.packed().feature.device.type != "cuda":
            raise AssertionError(f"fold {f} was not traversed on the card: backend "
                                 f"{rec['backend']}, device {forest.packed().feature.device}")
        t0 = time.perf_counter()
        host = forest.predict_proba_full(rec["x"], rec["n_classes"], backend="sklearn")
        host_s += time.perf_counter() - t0
        err = max(err, float(np.abs(host - rec["probs"]).max()))
        probs_host[(fold == f) & (gold >= 0)] = host
    s_host = bias_scores(np.nan_to_num(probs_host), gold, n_opts, rule=cfg.rf.score_rule)
    s_host = np.where(np.isfinite(probs_host).all(-1), s_host, np.nan)
    packed = folds[0]["forest"].packed()
    xt = torch.as_tensor(folds[0]["x"], device=device)
    dev_ms = median_ms(lambda: tforest.forest_predict_proba(packed, xt), samples=10, reps=3)
    acc, chance = report["blind_accuracy"], report["chance_accuracy"]
    zero = {key: 0 for key in counts}
    print(f"[diagnose-rf] diagnose-rf synthetic:0.5 n=512 k={cfg.data.k} rc={rc}: "
          f"blind_accuracy {acc:.4f} (chance {chance:.4f}), fold_accuracies "
          f"{report['fold_accuracies']}, top features {list(report['top_features'])[:5]}; "
          f"device vs host traversal of the same {len(folds)} forests of {cfg.rf.n_estimators} "
          f"trees: max|dprob| {err:.3e} (<= {RF_TOL}), same s(x) ranking "
          f"{same_ranking(s_dev, s_host)}; kernel launches {sum(counts.values())} (must be 0)")
    print(f"[diagnose-rf] fit (the port's own CART forest, host numpy) "
          f"{sum(r['fit_s'] for r in folds):.2f} s over {len(folds)} folds "
          f"({[round(r['fit_s'], 3) for r in folds]} s at {[r['n_train'] for r in folds]} rows, "
          f"{folds[0]['x'].shape[1]} features); traversal of fold 0 ({len(folds[0]['x'])} rows, "
          f"max depth {packed.max_depth}, {packed.feature.shape[1]} nodes): card {dev_ms:.4f} ms "
          f"(median of 10 x 3 calls), host {host_s / len(folds) * 1e3:.2f} ms a fold; CLI wall "
          f"{wall:.2f} s")
    if (rc != 0 or err > RF_TOL or not same_ranking(s_dev, s_host) or counts != zero
            or not acc > chance or len(rows) != len(ds)):
        raise AssertionError("diagnose-rf on the card failed its gates")
    return {"fit_s": sum(r["fit_s"] for r in folds), "traverse_ms": dev_ms, "max_abs_err": err}


def _ibp_artifacts(out_dir, n):
    """The IBP run's report (strict JSON), audit and split, checked."""
    from tst_torch.data.schema import BlindDataset

    with open(os.path.join(out_dir, "ibp_report.json")) as f:
        report = strict_json(f.read())
    check_audit(report, n)
    kept = [s.id for s in BlindDataset.load_jsonl(os.path.join(out_dir, "debiased.jsonl"))]
    removed = [s.id for s in BlindDataset.load_jsonl(os.path.join(out_dir, "removed.jsonl"))]
    check_split(n, kept, removed, _read_jsonl(os.path.join(out_dir, "sx.jsonl")))
    return report, len(kept), len(removed)


def ibp_round_plan(runner, alive, r):
    """What an SFT round of IBP launches, from the round's own survivors:
    its train steps (the batches it draws), its scorer chunks (each fold's
    held-out MCQ rows in chunks of 32, per scoring pass) and its decode
    prefill chunks (the surviving numeric rows, as the held-out decode
    sizes them), as ``_SftRoundRunner.run_round`` builds them."""
    from tst_torch.data.folds import kfold_assign
    from tst_torch.train.sft import make_fold_batches

    cfg, k, ds = runner.cfg, runner.k, runner.ds
    sub_idx = np.flatnonzero(alive)
    fold = np.full(len(ds), -1, np.int32)
    fold[sub_idx] = kfold_assign(ds.subset(sub_idx), k, cfg.data.seed + 1000 * r)
    seeds = max(int(cfg.optim.n_seeds), 1)
    steps = sum(make_fold_batches(fold, k, cfg.optim.batch_size, cfg.optim.epochs,
                                  cfg.data.seed + r + 31 * s, batch_multiple=cfg.mesh.data,
                                  include_mask=alive).shape[0] for s in range(seeds))
    mcq_fold = np.where(runner.tb.gold >= 0, fold, -1)
    passes = seeds * (len(runner.score_after) + 1)
    chunks = passes * k * math.ceil(max(int((mcq_fold == f).sum()) for f in range(k))
                                    / SCORER_BATCH)
    numeric = _numeric_rows(ds)
    numeric = numeric[alive[numeric]]
    dchunks = 0
    if len(numeric):
        dchunks = seeds * _decode_chunks(runner.spec, runner.params, runner.tokens.shape[1],
                                         fold[numeric], k)[1]
    return {"steps": steps, "scorer_chunks": chunks, "decode_chunks": dchunks}


def phase_debias_ibp():
    """``debias-ibp`` with the SFT diagnostic through the CLI: the rounds,
    the audit and the split add up, the report is strict JSON, the attention
    kernels launch as the rounds' own steps, scorer chunks and decode
    prefills imply; round 0's final adapters re-score its held-out MCQ rows
    through the plain attention, and the two s(x) agree in rank."""
    from tst_torch import cli
    from tst_torch.debias import ibp as tibp
    from tst_torch.diagnose.score import bias_scores
    from tst_torch.eval.parity import spearman

    rounds = []
    run_round, score = tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq

    def recorded_round(self, r, alive):
        rounds.append({"round": r, "alive": alive.copy(), "runner": self})
        return run_round(self, r, alive)

    def recorded_score(*args, **kw):
        probs = score(*args, **kw)
        if len(rounds) == 1:  # round 0: keep its last scoring pass's adapters
            lora = {p: {n: t.clone() for n, t in ab.items()} for p, ab in args[1].items()}
            rounds[0]["score"] = (args[:1] + (lora,) + args[2:], kw, probs)
        return probs

    out_dir = tempfile.mkdtemp(prefix="tst_torch_ibp_")
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq = recorded_round, recorded_score
    try:
        t0 = time.perf_counter()
        rc = cli.main(IBP + ["--out", out_dir])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq = run_round, score
    counts = _launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    report, n_kept, n_removed = _ibp_artifacts(out_dir, N_SAMPLES)
    for rec in rounds:
        rec["plan"] = ibp_round_plan(rec["runner"], rec["alive"], rec["round"])
    want = ibp_launches_want([r["plan"] for r in rounds])
    if rc != 0 or report["rounds_run"] != IBP_ROUNDS or len(rounds) != IBP_ROUNDS:
        raise AssertionError(f"debias-ibp rc={rc}, rounds_run {report['rounds_run']}, "
                             f"rounds recorded {len(rounds)}")
    check_launches(counts, want, "debias-ibp")
    walls = [{key: v for key, v in row.items() if key.startswith("round_")}
             for row in report["per_round"]]
    print(f"[debias-ibp] debias-ibp synthetic-vsi:0.4 n=512 k=2, {IBP_ROUNDS} rounds rc=0: "
          f"stop {report['stop_reason']}, n_alive {[r['n_alive'] for r in report['per_round']]}, "
          f"pruned {[r['pruned_this_round'] for r in report['per_round']]}, n_debiased "
          f"{report['n_debiased']} (debiased.jsonl {n_kept} + removed.jsonl {n_removed}; audit, "
          f"split and kept column agree; strict JSON); blind accuracy by round "
          f"{[round(r['blind_accuracy'], 4) for r in report['per_round']]} (chance "
          f"{[round(r['chance'], 4) for r in report['per_round']]}), numeric MRA "
          f"{[r.get('numeric_mra') for r in report['per_round']]}; rf_sft_spearman "
          f"{report.get('rf_sft_spearman')}; rounds' plans {[r['plan'] for r in rounds]}; "
          f"launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as implied); "
          f"CLI wall {wall:.2f} s; peak device memory {peak_gb:.2f} GB")
    print(f"[debias-ibp] round walls (s): {json.dumps(walls)}")

    # round 0's final adapters: its held-out MCQ rows through the plain attention
    args, kw, probs_k = rounds[0]["score"]
    runner = rounds[0]["runner"]
    t0 = time.perf_counter()
    probs_p = score(*args, **{**kw, "use_pallas": False})
    plain_s = time.perf_counter() - t0
    mcq = args[8] >= 0
    gold, n_opts, rule = runner.tb.gold, runner.tb.n_options, runner.cfg.rf.score_rule
    s_k, s_p = (bias_scores(p, gold, n_opts, rule=rule)[mcq] for p in (probs_k, probs_p))
    rho = spearman(s_k, s_p)
    print(f"[debias-ibp] round 0's held-out s(x) on its final adapters, {int(mcq.sum())} MCQ "
          f"rows: kernels vs plain attention Spearman {rho:.6f} (>= {IBP_SPEARMAN}), "
          f"max|dprob| {float(np.abs(probs_k - probs_p)[mcq].max()):.3e}; plain scoring "
          f"{plain_s:.2f} s")
    if not rho >= IBP_SPEARMAN:
        raise AssertionError("IBP round 0's s(x) through the kernels disagrees in rank with "
                             "the plain attention")
    del rounds, runner, args
    torch.cuda.empty_cache()
    return counts


def phase_debias_ibp_rf():
    """``debias-ibp --set ibp.diagnostic=rf`` through the CLI: two rounds,
    each pruning prune_mask's budget, the audit and split adding up, and no
    kernel launched."""
    from tst_torch import cli

    out_dir = tempfile.mkdtemp(prefix="tst_torch_ibp_rf_")
    _zero_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(IBP_RF + ["--out", out_dir])
    wall = time.perf_counter() - t0
    counts = _launch_counts()
    report, n_kept, n_removed = _ibp_artifacts(out_dir, N_SAMPLES)
    cfg, _ = cli._resolve_k(cli.build_parser().parse_args(IBP_RF))
    print(f"[debias-ibp-rf] debias-ibp ibp.diagnostic=rf synthetic:0.5 n=512 k={cfg.data.k} "
          f"rc={rc}: rounds_run {report['rounds_run']}, n_alive "
          f"{[r['n_alive'] for r in report['per_round']]}, pruned "
          f"{[r.get('pruned_this_round') for r in report['per_round']]} (prune_rate "
          f"{cfg.ibp.prune_rate}), n_debiased {report['n_debiased']} ({n_kept} + {n_removed}); "
          f"blind accuracy by round {[round(r['blind_accuracy'], 4) for r in report['per_round']]}"
          f"; round walls {[r['round_wall_s'] for r in report['per_round']]} s; kernel launches "
          f"{sum(counts.values())} (must be 0); CLI wall {wall:.2f} s")
    if (rc != 0 or report["rounds_run"] != IBP_RF_ROUNDS
            or not pruned_as_implied(report, cfg.ibp.prune_rate)
            or counts != {key: 0 for key in counts}):
        raise AssertionError("debias-ibp with the RF diagnostic failed its gates")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["rank", "mlp-int4"], default=None,
                        help="rank: the attention kernels against the library at the train "
                             "shape; mlp-int4: K3 and K4 against their plain versions, timed "
                             "(either runs on any build of tst_torch, so also a parent "
                             "commit's)")
    args = parser.parse_args(argv)
    device = phase_device()
    phase_build(sass=args.only is None)
    if args.only == "rank":
        phase_rank(device)
        return
    if args.only == "mlp-int4":
        print(json.dumps({"int4": phase_kernel_int4(device, strict=False),
                          "mlp": phase_kernel_mlp(device), "steps": phase_steps()}))
        return
    kern = phase_kernel(device)
    blind_launches = phase_slice()
    bwd = phase_kernel_bwd(device)
    counts = phase_train()
    phase_train_vs_plain()
    seg = phase_kernel_seg(device)
    packed = phase_train_packed()
    phase_train_packed_vs_plain()
    int4 = phase_kernel_int4(device)
    mlp = phase_kernel_mlp(device)
    decode = phase_decode_slice()
    fused = phase_train_fused()
    phase_diagnose_rf(device)
    ibp = phase_debias_ibp()
    phase_debias_ibp_rf()
    records = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_fwd.cu",
         "replaces": "tst/kernels/flash_attention.py:99",
         "launches": counts["fwd"], "launches_eval_blind": blind_launches,
         "launches_debias_ibp": ibp["fwd"], **kern, **bwd["fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:553",
         "launches": counts["dkv"], "launches_debias_ibp": ibp["dkv"], **bwd["dkv"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:518",
         "launches": counts["dq"], "launches_debias_ibp": ibp["dq"], **bwd["dq"]},
        {"name": "flash_attention_fwd_seg", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_fwd.cu",
         "replaces": "tst/kernels/flash_attention.py:464",
         "launches": packed["fwd_seg"], **seg["fwd"]},
        {"name": "flash_attention_bwd_dkv_seg", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:650",
         "launches": packed["dkv_seg"], **seg["dkv"]},
        {"name": "flash_attention_bwd_dq_seg", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:650",
         "launches": packed["dq_seg"], **seg["dq"]},
        {"name": "int4_matmul", "route": "cuda", "source": "tst_torch/csrc/int4_matmul.cu",
         "replaces": "tst/kernels/quant_matmul.py:64", "launches": decode["int4"],
         "launches_diagnose_sft": fused["int4"], **int4},
        {"name": "fused_swiglu_mlp", "route": "cuda", "source": "tst_torch/csrc/fused_mlp.cu",
         "replaces": "tst/kernels/fused_mlp.py:44", "launches": fused["mlp"], **mlp},
    ]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
