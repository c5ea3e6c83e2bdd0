"""GQA flash attention, forward and backward, causal (plain or
segment-masked for packed rows) or non-causal: hand-written CUDA kernels for
Hopper, inside a ``torch.autograd.Function``.

Counterpart of ``tst/kernels/flash_attention.py``: the forward of the Pallas
TPU kernels ``_fwd_kernel_oneshot`` / ``_fwd_kernel`` and their backward
(``_bwd_fused_nolse_kernel``, ``_bwd_dq_kernel(_oneshot)``,
``_bwd_dkv_kernel(_oneshot)``), each with its ``has_seg`` and its
``causal=False`` branch, and the segment-sparse
``_fwd_kernel_oneshot_chunked`` / ``_bwd_fused_chunked_kernel``.
The CUDA sources are ``tst_torch/csrc/flash_attention_fwd.cu`` and
``flash_attention_bwd.cu``; every product in both is a Hopper warpgroup
``wgmma`` on 128-byte-swizzled shared-memory tiles (``wgmma_sm90.cuh``,
``flash_sm90.cuh``; segments: ``seg_starts.cuh``). Their headers say what
bounds them on the card and how the design answers. The forward, dK/dV and
dQ kernels are persistent, warp-specialized and fed by TMA; the C entries take
the 64-row forward for packed rows at D=64, the 64-key dK/dV for packed rows
and at D=128, and the 64-row dQ for packed rows and non-causal at D=128,
where those are faster.

``flash_attention`` is differentiable on every device. For CUDA tensors its
forward launches the forward kernel and its backward the dK/dV and dQ
kernels (or raises: there is no fallback); for CPU tensors it takes the
plain versions, ``flash_attention_reference`` and
``flash_attention_backward_reference``, through the same Function. Layout is
the model's: q ``[B, S, H, D]``, k/v ``[B, S, KVH, D]``; outputs o
``[B, S, H, D]`` and an f32 logsumexp ``[B, H, S]`` (not differentiable).

Packed rows (``seg_starts``, int32 ``[B, n <= MAX_SEGS]`` ascending sample
offsets, unused slots ``>= SEG_PAD``, not differentiable): query i attends
to key j iff ``j <= i`` and ``j >= segment start of i`` (``segment_mask``).
They go to separate segmented kernels with their own launch counts; without
``seg_starts`` the plain kernels run as before.

``causal=False`` (every key visible; no ``seg_starts``, as in the reference)
goes to the non-causal instantiations of the same kernels, through the C
entries ``..._full``, with launch counts of their own. The ring's past
blocks take them (tst_torch.kernels.ring_attention), with the ring's own
row statistics: :func:`flash_attention_backward` takes lse and di as given.
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
#: launches of the segmented (packed-row) forward, dK/dV and dQ kernels
LAUNCHES_SEG = 0
LAUNCHES_SEG_BWD_DKV = 0
LAUNCHES_SEG_BWD_DQ = 0
#: launches of the non-causal (causal=False) forward, dK/dV and dQ kernels
LAUNCHES_FULL = 0
LAUNCHES_FULL_BWD_DKV = 0
LAUNCHES_FULL_BWD_DQ = 0

#: segment starts a packed row may carry, and the value of an unused slot
#: (the reference's, tst/kernels/flash_attention.py:159,166)
MAX_SEGS = 8
SEG_PAD = 1 << 30

#: S must be a multiple of it: the kernels' 64-row tiles (dQ; the 64-row
#: forward and dK/dV kept where they are faster), while the persistent
#: kernels' 128-row tiles end at S through 3-D TMA maps that fill past it
#: with zeros
BLOCK = 64
HEAD_DIMS = (64, 128)

_ENTRY = "tst_flash_attention_fwd"
_ENTRY_DKV = "tst_flash_attention_bwd_dkv"
_ENTRY_DQ = "tst_flash_attention_bwd_dq"


def segment_starts_per_pos(seg_starts: torch.Tensor, s: int) -> torch.Tensor:
    """[B, n] starts → [B, S] segment start of each position: the largest
    start <= pos, 0 where none is (``segment_starts_per_pos`` :1351)."""
    pos = torch.arange(s, dtype=seg_starts.dtype, device=seg_starts.device)[None, :, None]
    seg = seg_starts[:, None, :]
    return torch.where(seg <= pos, seg, torch.zeros_like(seg)).amax(-1)


def segment_mask(seg_starts: torch.Tensor, s: int) -> torch.Tensor:
    """[B, S, S] bool: ok[b, i, j] = j <= i and j >= segment start of i
    (``segment_mask`` :1360)."""
    start = segment_starts_per_pos(seg_starts, s)
    pos = torch.arange(s, device=seg_starts.device)
    return (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] >= start[:, :, None])


def _mask(q: torch.Tensor, causal: bool,
          seg_starts: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The attention mask: [B, S, S] for packed rows, else [S, S] or None."""
    s = q.shape[1]
    if seg_starts is not None:
        check_seg_starts(seg_starts, q, causal)
        return segment_mask(seg_starts, s)
    return torch.ones(s, s, dtype=torch.bool, device=q.device).tril() if causal else None


def _on_logits(mask: torch.Tensor) -> torch.Tensor:
    """A [S, S] or [B, S, S] mask broadcast to logits [B, KVH, G, S, S]."""
    return mask if mask.ndim == 2 else mask[:, None, None]


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense GQA attention → (o [B,S,H,D] in q's dtype, lse [B,H,S] f32).

    ``mask``: bool [S, S] shared or [B, S, S] per row (packed segments),
    True = attend; None attends everywhere. f32 logits scaled by 1/sqrt(D),
    masked to -1e30, softmax in f32, probabilities cast to the input dtype
    before P·V with f32 accumulation (``mha_reference`` /
    ``_dense_attention`` of the JAX package)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, s, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(d)
    if mask is not None:
        logits = logits.masked_fill(~_on_logits(mask), -1e30)
    lse = torch.logsumexp(logits, dim=-1)  # [B, KVH, G, S]
    probs = torch.exp(logits - lse[..., None]).to(q.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs.float(), v.float())
    return o.reshape(b, s, h, d).to(q.dtype), lse.reshape(b, h, s)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              causal: bool = True, seg_starts: Optional[torch.Tensor] = None,
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernels: (o, lse) on any device."""
    return masked_attention(q, k, v, _mask(q, causal, seg_starts))


def attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
        di: torch.Tensor, do: torch.Tensor, causal: bool = True,
        seg_starts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels from the row statistics
    they take, in f32 → (dq, dk, dv) in the dtypes of q, k, v.

    ``lse`` and ``di`` are f32 [B, H, S]: the softmax's logsumexp and Σ_d
    o·do of each row, given rather than computed here, so that a caller
    whose rows span several blocks (the ring) passes those of the whole row.
    P = exp(q·kᵀ/sqrt(D) − lse) (0 where masked), dv = Pᵀ·do and dk =
    dSᵀ·q/sqrt(D) summed over each GQA group, dS = P ⊙ (do·vᵀ − di), dq =
    dS·k/sqrt(D)."""
    b, s, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, s, kvh, g, d)
    dog = do.float().reshape(b, s, kvh, g, d)
    kf, vf = k.float(), v.float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) / math.sqrt(d)
    mask = _mask(q, causal, seg_starts)
    if mask is not None:
        logits = logits.masked_fill(~_on_logits(mask), float("-inf"))
    p = torch.exp(logits - lse.reshape(b, kvh, g, s, 1))  # [B, KVH, G, S, S]
    di = di.reshape(b, kvh, g, s)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    ds = p * (torch.einsum("bqkgd,bskd->bkgqs", dog, vf) - di[..., None]) / math.sqrt(d)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf).reshape(b, s, h, d)
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_backward_reference(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
        lse: torch.Tensor, do: torch.Tensor, causal: bool = True,
        seg_starts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernels, in f32 → (dq, dk, dv)
    in the dtypes of q, k, v: :func:`attention_backward_reference` with di =
    Σ_d o·do of this call's own o."""
    return attention_backward_reference(q, k, v, lse, backward_row_stat(o, do), do, causal,
                                        seg_starts)


def check_kernel_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> None:
    """Raise ValueError on anything the CUDA kernels do not take (``causal``
    either way: the causal and the non-causal kernels take the same shapes)."""
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


def check_seg_starts(seg_starts: torch.Tensor, q: torch.Tensor, causal: bool) -> None:
    """Raise ValueError on segment starts that neither the kernels nor the
    plain versions take (the reference's checks, :1256-1262 and ``seg_tile``)."""
    if not causal:
        raise ValueError("seg_starts (packed rows) needs causal=True")
    if seg_starts.dtype != torch.int32:
        raise ValueError(f"seg_starts is {seg_starts.dtype}; the kernels take torch.int32")
    if seg_starts.ndim != 2 or seg_starts.shape[0] != q.shape[0]:
        raise ValueError(f"seg_starts {tuple(seg_starts.shape)} is not [B, n] for the batch "
                         f"B={q.shape[0]} of q")
    if seg_starts.shape[1] > MAX_SEGS:
        raise ValueError(f"{seg_starts.shape[1]} segment starts a row > MAX_SEGS={MAX_SEGS}")
    if seg_starts.device != q.device:
        raise ValueError(f"seg_starts is on {seg_starts.device}, q on {q.device}")


def kernel_seg_starts(seg_starts: Optional[torch.Tensor], q: torch.Tensor,
                      causal: bool = True) -> Optional[torch.Tensor]:
    """Checked starts in the kernels' form: contiguous int32 [B, MAX_SEGS],
    unused slots SEG_PAD (None stays None: the unsegmented kernels)."""
    if seg_starts is None:
        return None
    check_seg_starts(seg_starts, q, causal)
    return torch.nn.functional.pad(seg_starts, (0, MAX_SEGS - seg_starts.shape[1]),
                                   value=SEG_PAD).contiguous()


def check_backward_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lse: torch.Tensor, di: torch.Tensor, do: torch.Tensor,
                        causal: bool = True) -> None:
    """Raise ValueError on anything the backward kernels do not take: q, k,
    v as the forward's, do like q, and the row statistics lse and di (f32
    [B, H, S])."""
    check_kernel_args(q, k, v, causal)
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q {tuple(q.shape)}")
    _check_operand("do", do, q, torch.bfloat16)
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (b, h, s):
            raise ValueError(f"{name} {tuple(t.shape)} is not [B, H, S] = {(b, h, s)}")
        _check_operand(name, t, q, torch.float32)


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


def _launch_fwd(q, k, v, seg=None, causal=True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on checked CUDA tensors → (o, lse); the segmented
    one when ``seg`` (``kernel_seg_starts``) is given, the non-causal one
    when ``causal`` is False."""
    global LAUNCHES, LAUNCHES_SEG, LAUNCHES_FULL
    b, s, h, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if seg is None:
        entry = _ENTRY if causal else _ENTRY + "_full"
        err = _bind(entry, 5)(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                              lse.data_ptr(), *_geometry(q, k))
        _raise_on(err, entry, q, k)
        if causal:
            LAUNCHES += 1
        else:
            LAUNCHES_FULL += 1
    else:
        entry = _ENTRY + "_seg"
        err = _bind(entry, 6)(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
                              o.data_ptr(), lse.data_ptr(), *_geometry(q, k))
        _raise_on(err, entry, q, k)
        LAUNCHES_SEG += 1
    return o, lse


def backward_row_stat(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = Σ_d o·do per row, f32 [B, H, S], from the forward's o (as the
    reference's ``_flash_bwd`` computes it outside its kernels)."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def _entry(base: str, seg, causal: bool) -> str:
    """A C entry's name: ``_seg`` for packed rows, ``_full`` when non-causal."""
    return base + ("_seg" if seg is not None else "" if causal else "_full")


def _launch_bwd_dkv(q, k, v, do, lse, di, seg=None, causal=True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel on checked CUDA tensors → (dk, dv); the segmented one
    when ``seg`` is given, the non-causal one when ``causal`` is False."""
    global LAUNCHES_BWD_DKV, LAUNCHES_SEG_BWD_DKV, LAUNCHES_FULL_BWD_DKV
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ins = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           di.data_ptr()]
    entry = _entry(_ENTRY_DKV, seg, causal)
    ptrs = ins + ([] if seg is None else [seg.data_ptr()]) + [dk.data_ptr(), dv.data_ptr()]
    _raise_on(_bind(entry, len(ptrs))(*ptrs, *_geometry(q, k)), entry, q, k)
    if seg is not None:
        LAUNCHES_SEG_BWD_DKV += 1
    elif causal:
        LAUNCHES_BWD_DKV += 1
    else:
        LAUNCHES_FULL_BWD_DKV += 1
    return dk, dv


def _launch_bwd_dq(q, k, v, do, lse, di, seg=None, causal=True) -> torch.Tensor:
    """The dQ kernel on checked CUDA tensors → dq; the segmented one when
    ``seg`` is given, the non-causal one when ``causal`` is False."""
    global LAUNCHES_BWD_DQ, LAUNCHES_SEG_BWD_DQ, LAUNCHES_FULL_BWD_DQ
    dq = torch.empty_like(q)
    ins = [q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
           di.data_ptr()]
    entry = _entry(_ENTRY_DQ, seg, causal)
    ptrs = ins + ([] if seg is None else [seg.data_ptr()]) + [dq.data_ptr()]
    _raise_on(_bind(entry, len(ptrs))(*ptrs, *_geometry(q, k)), entry, q, k)
    if seg is not None:
        LAUNCHES_SEG_BWD_DQ += 1
    elif causal:
        LAUNCHES_BWD_DQ += 1
    else:
        LAUNCHES_FULL_BWD_DQ += 1
    return dq


def flash_attention_backward(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
        di: torch.Tensor, do: torch.Tensor, causal: bool = True,
        seg_starts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) through the two CUDA backward kernels from the row
    statistics ``lse`` and ``di`` (f32 [B, H, S]; see
    :func:`attention_backward_reference`; di = ``backward_row_stat(o, do)``
    of the forward's o, or of the ring's combined rows): segmented kernels
    for packed rows (``seg_starts``), non-causal ones for ``causal=False``.
    CUDA tensors only: there is no fallback."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: the kernels take CUDA tensors, "
                         f"got {q.device}")
    check_backward_args(q, k, v, lse, di, do, causal)
    seg = kernel_seg_starts(seg_starts, q, causal)
    dk, dv = _launch_bwd_dkv(q, k, v, do, lse, di, seg, causal)
    return _launch_bwd_dq(q, k, v, do, lse, di, seg, causal), dk, dv


def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                         seg_starts: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, seg_starts)
    if q.device.type == "cuda":
        check_kernel_args(q, k, v, causal)
        return _launch_fwd(q, k, v, kernel_seg_starts(seg_starts, q, causal), causal)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


#: ``torch.ops.tst_torch.flash_attention_fwd(q, k, v, causal, seg_starts)``
#: → (o, lse): the forward kernel for CUDA tensors, its plain version for CPU
#: tensors. One operator, so that a selective-checkpoint policy can keep its
#: two outputs (remat "flash", tst_torch.models.decoder) and the
#: recomputation of a checkpointed layer does not run the kernel again.
_LIB = torch.library.Library("tst_torch", "DEF")
_LIB.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, bool causal, Tensor? seg_starts)"
            " -> (Tensor, Tensor)")
_LIB.impl("flash_attention_fwd", _flash_attention_fwd, "CompositeExplicitAutograd")
flash_attention_fwd = torch.ops.tst_torch.flash_attention_fwd.default


class _FlashAttention(torch.autograd.Function):
    """Forward (``flash_attention_fwd``) saves (q, k, v, o, lse, seg_starts);
    backward takes the kernels for CUDA tensors and the plain backward for
    CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal, seg_starts):
        o, lse = flash_attention_fwd(q, k, v, causal, seg_starts)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse, seg_starts)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seg_starts = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_reference(q, k, v, o, lse, do, ctx.causal,
                                                            seg_starts)
        else:
            do = do.contiguous()
            dq, dk, dv = flash_attention_backward(q, k, v, lse, backward_row_stat(o, do), do,
                                                  ctx.causal, seg_starts)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    seg_starts: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [B,S,H,D], lse [B,H,S] f32), differentiable in q, k and v: the CUDA
    kernels for CUDA tensors, the plain versions for CPU tensors. With
    ``seg_starts`` (int32 [B, n <= MAX_SEGS]) each query attends only within
    its own packed segment, through the segmented kernels; ``causal=False``
    attends to every key, through the non-causal kernels."""
    return _FlashAttention.apply(q, k, v, causal, seg_starts)
