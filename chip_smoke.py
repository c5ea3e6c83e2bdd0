#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tst_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # every phase below
    python3 chip_smoke.py --only rank  # phases 1-2, then the attention kernels vs the library

Phases, each printing one line; any failure raises and exits non-zero:

  1. device  — a CUDA device is present; its name and power limit;
  2. build   — nvcc builds every kernel from tst_torch/csrc (sm_90a); the
               count of wgmma (HGMMA) instructions in each backward kernel's
               SASS (cuobjdump), which must not be 0;
  3. kernel  — the flash-attention kernel against its plain PyTorch version
               on the card at the slice's shape, Llama-3-8B heads and one
               tile; bad shapes raise; median kernel and plain times;
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
               and chunk counts imply; report.json and the s(x) table; then
               the median train-step time after the first step;
  7. train, kernel vs plain — one fold-parallel step's LoRA gradients and
               losses through the kernels against ``model.use_pallas=false``
               on the same weights, adapters and batch (4 rows per fold);
  8. kernel-seg — the segmented (packed-row) forward, dK/dV and dQ kernels
               against their plain versions, and gradients through the
               autograd Function against autograd of the plain masked
               attention: at the packed train step's call with the run's own
               segment starts, at Llama-3-8B heads with 8 segments a row at
               S=2048, and at 128- and 64-token cases with starts inside
               tiles and a row of all SEG_PAD; bit-equal on a second call;
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
               leaf; median times, and one decode layer's seven projections;
 12. kernel-mlp — the fused SwiGLU MLP (K4) against its plain version at the
               int4 train step's shape, at Llama-3-8B widths and at an M that
               is no tile multiple; gradients through the autograd Function
               against autograd of the plain version; median times;
 13. decode-slice — ``python -m tst_torch eval-blind`` on synthetic-vsi:0.4
               (384 MCQ + 128 numeric rows, n=512) with ``model.quantize=int4``
               through the CLI: launch counts as the run implies (K3 on every
               int4 projection of every decode step); the first decode step's
               logits through K3 against the plain path on the same caches;
               decode step times and the device's idle share (profiler);
 14. train-fused — ``python -m tst_torch diagnose-sft`` on synthetic-vsi:0.4
               with ``model.quantize=int4 model.fused_mlp=true`` through the
               CLI: launch counts as implied (K4 on every train-step MLP, K3 on
               the held-out decode of both folds' rows at once); report.json
               and the s(x) table; one step's LoRA gradients and fold losses
               against the unfused plain path; median step time fused against
               unfused, their peak device memory, and a profile of the fused
               step.

The second-to-last line is the per-kernel JSON record (launches on the
main path, error, kernel, plain and library times, and the bound: the
larger of the function's bytes over 3.35 TB/s and its operations over
989 TFLOP/s bf16, counted from this run's shapes and masks), the last line
``{"ok": true, "device": {...}}``. Imports nothing of jax or of the JAX
package ``tst``, and neither does the port it drives.
"""

import argparse
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
#: the backward kernels also at one tile (S=64), at both head dims
BWD_ONE_TILE = [(3, 64, 14, 2, 64), (2, 64, 8, 2, 128)]
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
         "--set", "model.name=qwen2.5-0.5b", "--set", "rf.cross_check=false"]
#: rows per fold of the kernel-vs-plain step: the plain attention keeps
#: several f32 [rows, 14, 512, 512] tensors per layer for its backward
PLAIN_ROWS = 4
#: one bf16 step, kernel vs plain attention: per-leaf gradient cosine, and
#: per-fold losses (f32 head, bf16 model of 24 layers)
GRAD_COSINE, LOSS_TOL = 0.99, 1e-2
#: scale of the drawn LoRA B for that step (nonzero, so A has gradients)
B_SCALE = 0.005
STEP_SAMPLES = 8
PACKED = ["optim.pack=true"]
#: the packed train step's attention call: 2 folds x 16 rows of 1024 tokens
PACKED_TRAIN_SHAPE = (32, 1024, 14, 2, 64)
#: the other segmented checks: Llama-3-8B heads at S=2048, 8 segments a row
#: (where the TPU dispatches its chunked K2 bodies); 128- and 64-token cases
SEG_SHAPES = [(2, 2048, 32, 8, 128), (5, 128, 14, 2, 64), (5, 64, 14, 2, 64)]
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
#: caches: max |Δ| <= 2e-2 max |logit|, argmax agreement >= 0.95 over the
#: numeric rows (a random bf16 model of 24 layers: the plain path with its f32
#: sums taken in another order moves its logits as far, PERF.md)
LOGIT_TOL, FIRST_TOKEN_AGREE = 2e-2, 0.95
TRAIN_FUSED = ([a.replace("synthetic:0.5", "synthetic-vsi:0.4") for a in TRAIN]
               + ["--set", "model.quantize=int4", "--set", "model.fused_mlp=true"])


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
    regs = [ln.split(":", 1)[1].strip() for ln in res.log.splitlines() if "registers" in ln]
    print(f"[build] {res.path.name} nvcc {res.seconds:.1f} s; {'; '.join(regs)}")
    for ln in res.log.splitlines():
        if "warning" in ln or re.search(r"[1-9]\d* bytes spill", ln):
            print(f"[build] ptxas: {ln.strip()}")
    if not sass:
        return
    # wgmma in the backward kernels: HGMMA instructions in each one's SASS
    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(res.path)], check=True, capture_output=True,
                          text=True).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : \S*flash_bwd_(dkv|dq)_kernelILi(\d+)ELb([01])E", ln)
        if m:
            name = f"{m[1]}<D={m[2]}{', seg' if m[3] == '1' else ''}>"
            counts[name] = 0
        elif "Function :" in ln:
            name = None
        elif name and "HGMMA" in ln:
            counts[name] += 1
    print(f"[build] HGMMA instructions in the backward kernels' SASS: {counts}")
    if len(counts) != 8 or min(counts.values()) == 0:
        raise AssertionError(f"every backward kernel must run its products on wgmma: {counts}")


def phase_kernel(device):
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for b, s, h, kvh, d in KERNEL_SHAPES:
        rng = np.random.default_rng(s + d)
        q, k, v = (torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32))
                   .to(device, torch.bfloat16)
                   for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))
        o, lse = tfa.flash_attention(q, k, v)
        torch.cuda.synchronize()
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
    print(f"[kernel] S=100 rejected; slice shape {KERNEL_SHAPES[0]}: kernel "
          f"{out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms (median of 30 x 10 calls)")
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


def _check_bitwise(fn, got):
    """A second call of ``fn`` must give bit-equal outputs (no atomics, one
    fixed summation order)."""
    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("the backward kernels are not bit-reproducible")


def phase_kernel_bwd(device):
    """The dK/dV and dQ kernels against the plain backward (f32, same o and
    lse), and gradients through the autograd Function against autograd of
    the plain attention, at the forward's three shapes."""
    import tst_torch.kernels.flash_attention as tfa

    out = {}
    for b, s, h, kvh, d in KERNEL_SHAPES + BWD_ONE_TILE:
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
    """Which attention kernels lose most to the library: at the train
    step's shape, the forward kernel against scaled_dot_product_attention's
    forward and the backward pair (dK/dV + dQ kernels) against its backward,
    interleaved over ``rounds`` in one process (medians). The forward is
    ranked first only if it is slower than the library's forward and loses
    to it by a larger factor than the pair loses to the library's backward."""
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

    times = {"fwd": [], "pair": [], "library_fwd": [], "library_bwd": []}
    for _ in range(rounds):
        times["fwd"].append(median_ms(lambda: tfa._launch_fwd(q, k, v)))
        times["pair"].append(median_ms(pair))
        lib = _sdpa_yardstick(q, k, v, do, o)
        times["library_fwd"].append(lib["fwd_ms"])
        times["library_bwd"].append(lib["bwd_ms"])
    med = {key: statistics.median(val) for key, val in times.items()}
    f_fwd, f_pair = med["fwd"] / med["library_fwd"], med["pair"] / med["library_bwd"]
    first = ("forward" if med["fwd"] > med["library_fwd"] and f_fwd > f_pair
             else "backward pair")
    print(f"[rank] train shape {TRAIN_SHAPE}, {rounds} interleaved rounds (medians; per round "
          f"{json.dumps({key: [round(x, 4) for x in val] for key, val in times.items()})}): "
          f"forward {med['fwd']:.4f} ms vs scaled_dot_product_attention ({lib['backend']}, "
          f"{lib['gqa']}) {med['library_fwd']:.4f} ms, factor {f_fwd:.3f}; backward pair "
          f"{med['pair']:.4f} ms vs {med['library_bwd']:.4f} ms, factor {f_pair:.3f}; "
          f"loses most: the {first}")


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
    if (rc != 0 or counts != want or report["n_mcq"] != N_SAMPLES or len(rows) != N_SAMPLES
            or not (loss is not None and math.isfinite(loss))
            or not ((sx >= 0) & (sx <= 1)).all()):
        raise AssertionError(f"diagnose-sft rc={rc}, launches {counts} (want {want}), "
                             f"n_mcq {report['n_mcq']}, sx rows {len(rows)}, final_loss {loss}")
    print(f"[train] diagnose-sft rc=0, {steps} steps x {k} folds, {chunks} scorer chunks; "
          f"launches fwd {counts['fwd']} dkv {counts['dkv']} dq {counts['dq']} (as implied); "
          f"final_loss {loss:.4f}, blind_accuracy {report['blind_accuracy']:.4f}, "
          f"fold_accuracies {report['fold_accuracies']}; train {report['train_wall_seconds']} s "
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
    (loss_k, grads_k), (loss_p, grads_p) = states[True], states[False]
    cos = {f"{p}.{n}": torch.nn.functional.cosine_similarity(
               grads_k[p][n].float().flatten(), grads_p[p][n].float().flatten(), dim=0).item()
           for p in grads_k for n in grads_k[p]}
    dloss = (loss_k - loss_p).abs().max().item()
    worst = min(cos, key=cos.get)
    print(f"[train-vs-plain] {PLAIN_ROWS} rows per fold: fold losses kernel "
          f"{loss_k.tolist()} plain {loss_p.tolist()} (max |d| {dloss:.3e} <= {LOSS_TOL}); "
          f"LoRA gradient cosine min {cos[worst]:.5f} ({worst}) over {len(cos)} leaves "
          f"(>= {GRAD_COSINE})")
    if dloss > LOSS_TOL or cos[worst] < GRAD_COSINE:
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
    starts), Llama-3-8B heads at S=2048 with 8 segments, and one 128-token
    case; then times at the train step's shape."""
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
    (loss_k, grads_k), (loss_p, grads_p) = grads[True], grads[False]
    cos = {f"{p}.{n}": torch.nn.functional.cosine_similarity(
               grads_k[p][n].float().flatten(), grads_p[p][n].float().flatten(), dim=0).item()
           for p in grads_k for n in grads_k[p]}
    dloss = (loss_k - loss_p).abs().max().item()
    worst = min(cos, key=cos.get)
    pk, pp = probs[True], probs[False]
    diff = float(np.abs(pk - pp).max())
    agree = float((pk.argmax(-1) == pp.argmax(-1)).mean())
    print(f"[train-packed-vs-plain] {PACKED_PLAIN_ROWS} packed rows per fold: fold losses "
          f"kernel {loss_k.tolist()} plain {loss_p.tolist()} (max |d| {dloss:.3e} <= "
          f"{LOSS_TOL}); LoRA gradient cosine min {cos[worst]:.5f} ({worst}) over {len(cos)} "
          f"leaves (>= {GRAD_COSINE}); packed scorer letter probabilities max|dprob| "
          f"{diff:.3e} (<= {PROB_TOL}), argmax agreement {agree:.4f} (>= {ARGMAX_AGREE}), "
          f"accuracy {float((pk.argmax(-1) == gold).mean()):.4f}; scoring {secs[True]:.3f} s "
          f"kernel, {secs[False]:.3f} s plain")
    if (dloss > LOSS_TOL or cos[worst] < GRAD_COSINE or pk.shape != (N_SAMPLES, 4)
            or not np.isfinite(pk).all() or diff > PROB_TOL or agree < ARGMAX_AGREE):
        raise AssertionError("the packed path through the kernels disagrees with the plain path")


def _profile(fn, steps):
    """Per call of ``fn``: the synchronized wall ms of ``steps`` calls
    without the profiler, and the device's busy ms from a torch.profiler
    trace of ``steps`` more (the sum of kernel times); the idle share is
    1 - busy / wall. The profiler's own host cost stays out of the wall: a
    launch-bound loop runs several times slower under it. Also the five
    kernels that take the most device time, with their launches per call,
    and the twelve host ops whose launches take the most device time (a
    hand-written kernel counts under the op that launched it). Busy and
    idle are None where the trace shows no device time."""
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
    return {"wall_ms": wall_ms, "busy_ms": busy, "idle_share": 1.0 - busy / wall_ms, "top": top,
            "ops": by_op}


def _fmt_profile(p):
    if p["busy_ms"] is None:
        return f"wall {p['wall_ms']:.3f} ms; device time not measured (no kernel time in trace)"
    return (f"wall {p['wall_ms']:.3f} ms, device busy {p['busy_ms']:.3f} ms, idle share "
            f"{p['idle_share']:.3f}; top kernels: {'; '.join(p['top'])}")


def phase_kernel_int4(device):
    """K3 against its plain version at decode's M for every int4 leaf of
    Qwen2.5-0.5B and Llama-3-8B (layer 1 of a 2-layer stack, weights drawn in
    bf16 and quantized as the model's are); times at every Qwen shape."""
    import tst_torch.kernels.quant_matmul as tqm
    from tst_torch.models.quant import quantize_leaf

    g = torch.Generator(device=device).manual_seed(11)
    layer = {m: {"ms": 0.0, "plain_ms": 0.0} for m in INT4_M}
    worst = 0.0
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
            worst = max(worst, err)
            line = f"[kernel-int4] {name} M={m} K={k} N={n}: max|out-ref|/max|ref| {rel:.3e}"
            if name in QWEN_INT4:
                ms = median_ms(lambda: tqm._launch(y, q, sc, 1))
                plain = median_ms(lambda: tqm.int4_matmul_reference(y, q, sc, 1))
                layer[m]["ms"] += ms
                layer[m]["plain_ms"] += plain
                line += f"; kernel {ms:.4f} ms, plain {plain:.4f} ms"
            print(line + f" (<= {INT4_TOL})")
        del q, sc
    for m in INT4_M:
        print(f"[kernel-int4] one decode layer's 7 projections at M={m}: kernel "
              f"{layer[m]['ms']:.4f} ms, plain (dequantize, then product) "
              f"{layer[m]['plain_ms']:.4f} ms (sums of medians of 30 x 10 calls)")
    # a layer's seven projections at M=32: y, packed weights and f32 scales in, f32 out
    m = INT4_M[0]
    flops = sum(2 * m * k * n for k, n in QWEN_INT4.values())
    nbytes = sum(m * k * 2 + k * n // 2 + (k // 128) * n * 4 + m * n * 4
                 for k, n in QWEN_INT4.values())
    return {"max_abs_err": worst, "ms": layer[m]["ms"], "plain_ms": layer[m]["plain_ms"],
            "library_ms": None, **_bound(flops, nbytes),
            "timed": f"sum over one Qwen2.5-0.5B layer's 7 projections at M={m}"}


def phase_kernel_mlp(device):
    """K4 against its plain version and the decoder's unfused bf16 MLP;
    gradients of all four inputs through the autograd Function against
    autograd of the plain version; times at the train step's shape."""
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
        if (m, d, f) == MLP_SHAPES[0]:
            def unfused():
                act = torch.nn.functional.silu((x @ wg).float()).to(x.dtype) * (x @ wu)
                return act @ wd

            out = {"max_abs_err": fwd_abs, "ms": median_ms(lambda: tfm._launch(x, wg, wu, wd)),
                   "plain_ms": median_ms(lambda: tfm.swiglu_reference(x, wg, wu, wd),
                                         samples=10, reps=3, warmup=1),
                   "library_ms": None,  # no single torch call computes the fused MLP
                   "unfused_bf16_ms": median_ms(unfused, samples=10, reps=3, warmup=1),
                   **_bound(3 * 2 * m * d * f, 2 * m * d * 2 + 3 * d * f * 2)}
        del x, wg, wu, wd, dout, got, want
        torch.cuda.empty_cache()
    flops = 3 * 2 * np.prod(MLP_SHAPES[0]) / 1e12
    print(f"[kernel-mlp] train shape {MLP_SHAPES[0]}: kernel {out['ms']:.4f} ms "
          f"({flops / out['ms'] * 1e3:.1f} TFLOP/s), plain (f32 products, the reference's "
          f"numbers) {out['plain_ms']:.4f} ms, the decoder's unfused bf16 MLP "
          f"{out['unfused_bf16_ms']:.4f} ms (kernel: median of 30 x 10 calls; others 10 x 3)")
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
    from tst_torch.models.decode import _decode_step, chunk_logits, greedy_decode, prefill
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
    rels, agree, whole, per_tok, gaps = [], 0, 0, 0.0, []
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
        same = lk.argmax(-1) == lp.argmax(-1)
        agree += int(same.sum().item())
        top2 = lp.topk(2, dim=-1).values
        gaps += (top2[:, 0] - top2[:, 1])[~same].tolist()
        gen_k, gen_p = (greedy_decode(params, tok, plen, MAX_NEW, spec, use_pallas=up)
                        for up in (True, False))
        whole += int((gen_k == gen_p).all(-1).sum().item())
        per_tok += (gen_k == gen_p).float().sum().item() / MAX_NEW
    first = agree / len(rows)
    print(f"[decode-slice] first decode step of the {len(rows)} numeric rows ({DECODE_ROWS} a "
          f"chunk), same caches: K3 vs plain max|dlogit|/max|logit| {max(rels):.3e} "
          f"(<= {LOGIT_TOL}), argmax agreement {first:.4f} (>= {FIRST_TOKEN_AGREE}; the plain "
          f"path's top-2 gap on the rows that differ: {[round(g, 4) for g in gaps]}); greedy "
          f"continuations ({MAX_NEW} tokens): whole-row agreement {whole / len(rows):.4f}, "
          f"per-token {per_tok / len(rows):.4f}")
    if max(rels) > LOGIT_TOL or first < FIRST_TOKEN_AGREE:
        raise AssertionError("the decode step through K3 disagrees with the plain path")

    # step times and the device's idle share in the step
    step = {}
    with torch.inference_mode():
        for up in (True, False):
            def one(up=up):
                _decode_step(params, None, None, spec, tok0, plen, s, plen, s, kc, vc,
                             use_pallas=up, head=head, rope=rope)
            step[up] = _profile(one, 10)
    for up, name in ((True, "through K3"), (False, "plain path (dequantize, then product)")):
        print(f"[decode-slice] decode step ({DECODE_ROWS} rows, 24 layers), {name}: "
              f"{DECODE_ROWS / step[up]['wall_ms'] * 1e3:.1f} tokens/s; "
              f"{_fmt_profile(step[up])}")
    return counts


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
    (loss_k, grads_k), (loss_p, grads_p) = states[True], states[False]
    cos = {f"{p}.{n}": torch.nn.functional.cosine_similarity(
               grads_k[p][n].float().flatten(), grads_p[p][n].float().flatten(), dim=0).item()
           for p in grads_k for n in grads_k[p]}
    dloss = (loss_k - loss_p).abs().max().item()
    worst = min(cos, key=cos.get)
    print(f"[train-fused] {PLAIN_ROWS} rows per fold, fused kernels vs unfused plain path: "
          f"fold losses {loss_k.tolist()} vs {loss_p.tolist()} (max |d| {dloss:.3e} <= "
          f"{LOSS_TOL}); LoRA gradient cosine min {cos[worst]:.5f} ({worst}) over {len(cos)} "
          f"leaves (>= {GRAD_COSINE})")
    if dloss > LOSS_TOL or cos[worst] < GRAD_COSINE:
        raise AssertionError("the fused train step disagrees with the unfused plain path")
    del states, grads_k, grads_p

    # step times fused vs unfused (both int4, flash kernels), peak memory
    timing = {}
    for fused in (True, False):
        st2 = st if fused else _train_state(["model.fused_mlp=false"], base=TRAIN_FUSED)
        lora, opt = st2.lora, st2.opt_state
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for t in range(STEP_SAMPLES + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lora, opt, _ = st2.trainer.step(st2.params, lora, opt, st2.tokens, st2.loss_mask,
                                            st2.answer_pos, st2.batches[t])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        prof = _profile(lambda: st2.trainer.step(st2.params, lora, opt, st2.tokens,
                                                 st2.loss_mask, st2.answer_pos,
                                                 st2.batches[0]), 2)
        timing[fused] = (statistics.median(times[1:]) * 1e3, peak, prof)
        del st2, lora, opt
        torch.cuda.empty_cache()
    rows_per_step = int(np.prod(st.batches.shape[1:]))
    for fused, name in ((True, "fused (K4)"), (False, "unfused")):
        ms, peak, prof = timing[fused]
        print(f"[train-fused] int4 step {name} ({rows_per_step} rows of {st.tokens.shape[1]} "
              f"tokens): median {ms:.2f} ms over {STEP_SAMPLES} steps after the first "
              f"({rows_per_step / ms * 1e3:.1f} samples/s), peak device memory {peak:.2f} GB; "
              f"profile of one step: {_fmt_profile(prof)}")
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", choices=["rank"], default=None,
                        help="rank: the attention kernels against the library at the train "
                             "shape (any build of tst_torch, so also a parent commit's)")
    args = parser.parse_args(argv)
    device = phase_device()
    phase_build(sass=args.only != "rank")
    if args.only == "rank":
        phase_rank(device)
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
    records = [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_fwd.cu",
         "replaces": "tst/kernels/flash_attention.py:99",
         "launches": counts["fwd"], "launches_eval_blind": blind_launches, **kern,
         **bwd["fwd"]},
        {"name": "flash_attention_bwd_dkv", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:553",
         "launches": counts["dkv"], **bwd["dkv"]},
        {"name": "flash_attention_bwd_dq", "route": "cuda",
         "source": "tst_torch/csrc/flash_attention_bwd.cu",
         "replaces": "tst/kernels/flash_attention.py:518",
         "launches": counts["dq"], **bwd["dq"]},
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
