"""Attention of a decode step over its KV cache: a hand-written CUDA kernel
whose result for a query does not depend on the call's shape.

The reference computes this attention in ``jnp`` inside its decode step
(``tst/models/decode.py:196-201``); there is no Pallas kernel. The port keeps
the plain version, :func:`cache_attention_reference`, for CPU tensors, and
launches ``tst_torch/csrc/decode_attention.cu`` for CUDA tensors (or raises:
there is no fallback). The kernel sums over the visible slots by their rank
in slot order, in a structure fixed by the ranks and their count
(:func:`rank_plan`), so a query's output is the same bits at any number of
queries a call (a greedy step's T = 1, speculative decode's verify chunk's
gamma + 1), any cache length, and wherever the masked slots sit: what makes
speculative decode equal to greedy decode, token for token (ROADMAP §3, F1).
Its header says how.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import numpy as np
import torch

from tst_torch.kernels import _build

#: calls of the kernel's C entry made in this process (one kernel, or two
#: for a cache longer than a superchunk)
LAUNCHES = 0
#: the kernel's head dims, and the most cache slots its shared memory takes
HEAD_DIMS = (64, 128)
MAX_SLOTS = 27648
#: slots the plain version takes at a time (its memory: one
#: [B, T, H, SLOT_CHUNK, D] f64 product)
SLOT_CHUNK = 64
_ENTRY = "tst_decode_attention"


def cache_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              mask: torch.Tensor) -> torch.Tensor:
    """Plain version. q [B, T, H, D]; k, v [B, S, KVH, D] (GQA); mask bool
    [B, T, S], True where the query may see the slot → [B, T, H, D] in q's
    dtype: f32 scores masked to -1e30, an f32 softmax rounded to q's dtype,
    f32 sums of p·v (the reference's arithmetic).

    Each score is an elementwise product summed over D, and the softmax's
    sum and the sum of p·v run in slot order: the last entries of cumulative
    sums over the slots, which on the CPU add in slot order in f64 (an f32
    cumulative sum's accumulator there), the p·v sum carried in f64 from one
    :data:`SLOT_CHUNK` of slots to the next as the first term of the next
    chunk's sum. So, as in the kernel, a masked slot's exact 0 changes no
    bit, and a query's output does not depend on T, S, the chunk or where
    the masked slots sit. Memory: the [B, T, H, S] scores and one chunk's
    f64 product."""
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, 1, d).float()
    keys = k.permute(0, 2, 1, 3)[:, None, :, None]  # [B, 1, KVH, 1, S, D]
    values = v.permute(0, 2, 1, 3)[:, None, :, None]
    chunks = range(0, s, SLOT_CHUNK)
    scores = torch.cat([(qg * keys[..., c: c + SLOT_CHUNK, :].float()).sum(-1) for c in chunks],
                       -1) / np.sqrt(d)  # [B, T, KVH, G, S]
    scores = scores.masked_fill(~mask[:, :, None, None], -1e30)
    e = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = (e / e.cumsum(-1)[..., -1:]).to(q.dtype).float()
    out = None
    for c in chunks:
        terms = (probs[..., c: c + SLOT_CHUNK, None]
                 * values[..., c: c + SLOT_CHUNK, :].float()).double()
        if out is not None:
            terms = torch.cat([out[..., None, :], terms], -2)
        out = terms.cumsum(-2)[..., -1, :]
    return out.float().to(q.dtype).reshape(b, t, h, d)


def check_kernel_args(q, k, v, mask) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or mask.ndim != 3:
        raise ValueError(f"want q [B, T, H, D], k and v [B, S, KVH, D], mask [B, T, S]; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(mask.shape)}")
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if (k.shape[0] != b or k.shape[3] != d or h % kvh or mask.shape != (b, t, s)
            or d not in HEAD_DIMS or not 0 < s <= MAX_SLOTS):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, mask {tuple(mask.shape)}: "
                         f"the kernel takes D in {HEAD_DIMS}, H a multiple of KVH and at most "
                         f"{MAX_SLOTS} slots")
    device = q.get_device()
    for name, x, dtype in (("q", q, torch.bfloat16), ("k", k, torch.bfloat16),
                           ("v", v, torch.bfloat16), ("mask", mask, torch.bool)):
        if x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype}; the kernel takes {dtype}")
        if x.get_device() != device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def rank_plan(d: int) -> Tuple[int, int]:
    """(ranks a chunk, ranks a superchunk) of the kernel's sums at head dim
    ``d``, as its C entry states them (needs the built kernel): the
    structure every score, max, sum and p·v of a query follows. The plan
    takes no S and no T, so a query's bits are the same in a greedy step, in
    a verify chunk and in a longer cache; a cache longer than a superchunk
    only takes the two-kernel path (:func:`scratch_bytes` > 0)."""
    fn = getattr(_build.library(), _ENTRY + "_rank_plan")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    chunk, sup = ctypes.c_int(), ctypes.c_int()
    if fn(d, ctypes.byref(chunk), ctypes.byref(sup)) != 0:
        raise ValueError(f"the decode attention kernel takes D in {HEAD_DIMS}, not {d}")
    return chunk.value, sup.value


@functools.lru_cache(maxsize=None)
def _entry():
    fn = getattr(_build.library(), _ENTRY)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_long] + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return fn


@functools.lru_cache(maxsize=None)
def scratch_bytes(b: int, t: int, s: int, h: int, kvh: int, d: int) -> int:
    """The scratch bytes the C entry needs at this shape: 0 where it takes
    one kernel (S at most a superchunk), else the two-kernel path's."""
    fn = getattr(_build.library(), _ENTRY + "_scratch")
    fn.restype = ctypes.c_long
    fn.argtypes = [ctypes.c_int] * 6
    nbytes = fn(b, t, s, h, kvh, d)
    if nbytes < 0:
        raise RuntimeError(f"{_ENTRY}_scratch refused ({b}, {t}, {s}, {h}, {kvh}, {d})")
    return nbytes


def _launch(q, k, v, mask) -> torch.Tensor:
    global LAUNCHES
    b, t, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    nbytes = scratch_bytes(b, t, s, h, kvh, d)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                   None if scratch is None else scratch.data_ptr(), nbytes,
                   b, t, s, h, kvh, d, 1.0 / float(np.sqrt(d)),
                   q.device.index, _build.current_stream(q.device))
    if err != 0:
        raise RuntimeError(f"{_ENTRY} failed with cudaError_t {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)})")
    LAUNCHES += 1
    return out


def cache_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The decode step's attention over its cache (arguments as
    :func:`cache_attention_reference`): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return cache_attention_reference(q, k, v, mask)
    if q.device.type != "cuda":
        raise ValueError(f"cache_attention: unsupported device {q.device}")
    check_kernel_args(q, k, v, mask)
    return _launch(q, k, v, mask)
