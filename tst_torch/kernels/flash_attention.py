"""Causal GQA flash attention, forward and backward: hand-written CUDA
kernels for Hopper, inside a ``torch.autograd.Function``.

Counterpart of ``tst/kernels/flash_attention.py``: the forward of the Pallas
TPU kernels ``_fwd_kernel_oneshot`` / ``_fwd_kernel`` and their backward
(``_bwd_fused_nolse_kernel``, ``_bwd_dq_kernel(_oneshot)``,
``_bwd_dkv_kernel(_oneshot)``). The CUDA sources are
``tst_torch/csrc/flash_attention_fwd.cu`` and ``flash_attention_bwd.cu``;
their headers say what bounds them on the card and how the design answers.

``flash_attention`` is differentiable on every device. For CUDA tensors its
forward launches the forward kernel and its backward the dK/dV and dQ
kernels (or raises: there is no fallback); for CPU tensors it takes the
plain versions, ``flash_attention_reference`` and
``flash_attention_backward_reference``, through the same Function. Layout is
the model's: q ``[B, S, H, D]``, k/v ``[B, S, KVH, D]``; outputs o
``[B, S, H, D]`` and an f32 logsumexp ``[B, H, S]`` (not differentiable).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tst_torch.kernels import _build

#: forward-kernel launches made in this process
LAUNCHES = 0
#: dK/dV-kernel and dQ-kernel launches made in this process
LAUNCHES_BWD_DKV = 0
LAUNCHES_BWD_DQ = 0

#: query/key tile of the kernels: S must be a multiple of it
BLOCK = 64
HEAD_DIMS = (64, 128)

_ENTRY = "tst_flash_attention_fwd"
_ENTRY_DKV = "tst_flash_attention_bwd_dkv"
_ENTRY_DQ = "tst_flash_attention_bwd_dq"


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense GQA attention → (o [B,S,H,D] in q's dtype, lse [B,H,S] f32).

    ``mask``: bool [S, S], True = attend; None attends everywhere. f32
    logits scaled by 1/sqrt(D), masked to -1e30, softmax in f32,
    probabilities cast to the input dtype before P·V with f32 accumulation
    (``mha_reference`` / ``_dense_attention`` of the JAX package)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~mask, -1e30)
    lse = torch.logsumexp(logits, dim=-1)  # [B, KVH, G, S]
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return o.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def _causal_mask(s: int, device) -> torch.Tensor:
    return torch.ones(s, s, dtype=torch.bool, device=device).tril()


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel: (o, lse) on any device."""
    return masked_attention(q, k, v, _causal_mask(q.shape[1], q.device) if causal else None)


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor,
        causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, in f32 → (dq, dk, dv)
    in the dtypes of q, k, v.

    P = exp(q·kᵀ/sqrt(D) − lse) (0 where masked), di = Σ_d o·do per row,
    dv = Pᵀ·do and dk = dSᵀ·q/sqrt(D) summed over each GQA group,
    dS = P ⊙ (do·vᵀ − di), dq = dS·k/sqrt(D)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, s, kvh, g, d)
    dog = do.float().reshape(b, s, kvh, g, d)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) / math.sqrt(d)
    if causal:
        logits = logits.masked_fill(~_causal_mask(s, q.device), float("-inf"))
    p = torch.exp(logits - lse.reshape(b, kvh, g, s, 1))  # [B, KVH, G, S, S]
    di = (o.float() * do.float()).sum(-1).reshape(b, s, kvh, g).permute(0, 2, 3, 1)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dog, vf) - di[..., None]) / math.sqrt(d)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> None:
    """Raise ValueError on anything the CUDA kernels do not take."""
    if not causal:
        raise ValueError("the flash-attention kernel is causal only")
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"want q [B,S,H,D], k/v [B,S,KVH,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)} (self-attention, same batch and head dim)")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported; the kernel takes {HEAD_DIMS}")
    if s == 0 or s % BLOCK:
        raise ValueError(f"sequence length {s} is not a positive multiple of {BLOCK}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q, torch.bfloat16)


def _check_operand(name: str, t: torch.Tensor, q: torch.Tensor, dtype) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}; the kernel takes {dtype}")
    if t.device != q.device:
        raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def check_backward_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor) -> None:
    """Raise ValueError on anything the backward kernels do not take."""
    check_kernel_args(q, k, v, True)
    b, s, h, _ = q.shape
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} does not match q {tuple(q.shape)}")
        _check_operand(name, t, q, torch.bfloat16)
    if lse.shape != (b, h, s):
        raise ValueError(f"lse {tuple(lse.shape)} is not [B, H, S] = {(b, h, s)}")
    _check_operand("lse", lse, q, torch.float32)


def _bind(name: str, n_ptrs: int):
    fn = getattr(_build.library(), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    return fn


def _raise_on(err: int, entry: str, q: torch.Tensor, k: torch.Tensor) -> None:
    if err != 0:
        raise RuntimeError(f"{entry} failed with cudaError_t {err} "
                           f"(q {tuple(q.shape)}, k {tuple(k.shape)})")


def _geometry(q, k):
    b, s, h, d = q.shape
    return (b, s, h, k.shape[2], d, 1.0 / math.sqrt(d), q.device.index,
            torch.cuda.current_stream(q.device).cuda_stream)


def _launch_fwd(q, k, v) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on checked CUDA tensors → (o, lse)."""
    global LAUNCHES
    b, s, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    err = _bind(_ENTRY, 5)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                           lse.data_ptr(), *_geometry(q, k))
    _raise_on(err, _ENTRY, q, k)
    LAUNCHES += 1
    return o, lse


def backward_row_stat(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·do per row, f32 [B, H, S], from the forward's o (as the
    reference's ``_flash_bwd`` computes it outside its kernels)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _launch_bwd_dkv(q, k, v, do, lse, di) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel on checked CUDA tensors → (dk, dv)."""
    global LAUNCHES_BWD_DKV
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _bind(_ENTRY_DKV, 8)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                               lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                               *_geometry(q, k))
    _raise_on(err, _ENTRY_DKV, q, k)
    LAUNCHES_BWD_DKV += 1
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, di) -> torch.Tensor:
    """The dQ kernel on checked CUDA tensors → dq."""
    global LAUNCHES_BWD_DQ
    dq = torch.empty_like(q)
    err = _bind(_ENTRY_DQ, 7)(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                              lse.data_ptr(), di.data_ptr(), dq.data_ptr(), *_geometry(q, k))
    _raise_on(err, _ENTRY_DQ, q, k)
    LAUNCHES_BWD_DQ += 1
    return dq


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the two CUDA backward kernels; CUDA tensors only."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: the kernels take CUDA tensors, "
                         f"got {q.device}")
    do = do.contiguous()
    check_backward_args(q, k, v, o, lse, do)
    di = backward_row_stat(o, do)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, di)
    return _launch_bwd_dq(q, k, v, do, lse, di), dk, dv


class _FlashAttention(torch.autograd.Function):
    """Forward saves (q, k, v, o, lse); backward takes the kernels for CUDA
    tensors and the plain backward for CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        if q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, causal)
        elif q.device.type == "cuda":
            check_kernel_args(q, k, v, causal)
            o, lse = _launch_fwd(q, k, v)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do, ctx.causal)
        else:
            dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B,S,H,D], lse [B,H,S] f32), differentiable in q, k and v: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    return _FlashAttention.apply(q, k, v, causal)
