"""Packed-int4 dequant-matmul for the decode step: a hand-written CUDA kernel
for Hopper that reads the layer stack in place.

Counterpart of ``tst/kernels/quant_matmul.py``: ``int4_matmul_stacked``
(:159), the 2-D ``int4_matmul`` (:239) and the Pallas bodies ``_kernel`` /
``_kernel_pipe`` (:64, :87). The CUDA source is
``tst_torch/csrc/int4_matmul.cu``; its header says what bounds it on the card
and how the design answers.

Layout (tst_torch.models.quant): ``q`` int8 ``[L, K, N/2]`` with column j in
the low nibble (biased +8) and column j + N/2 in the high nibble (signed);
``scale`` f32 ``[L, K/128, 1, N]``. ``layer`` indexes the stack: the kernel
offsets its pointers, so the layer's bytes are never sliced out or copied.
For CUDA tensors the wrapper launches the kernel (or raises: there is no
fallback); for CPU tensors it takes the plain version,
:func:`int4_matmul_reference` (dequantize to y's dtype, then one product
with f32 accumulation: ``qdot``'s numbers). The TPU kernel's limits (M a
multiple of 8, N/2 a multiple of 128) do not apply: the CUDA kernel takes
any M, K a multiple of 128 and N/2 a multiple of 64. Inference only.

One call is one launch. K is split over the blocks of a thread-block
cluster by :func:`split_plan`, computed once a leaf shape and the same at
every M; the entry point is
typed once, and the wrapper allocates only the output: the decode step makes
168 of these calls, and their host cost is most of the step.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tst_torch.kernels import _build
from tst_torch.models.quant import INT4_GROUP, _unpack_half

#: kernel launches made in this process
LAUNCHES = 0

GROUP = INT4_GROUP
#: the kernel's constraint on N/2 (packed columns per block)
NH_MULTIPLE = 64
#: rows of y a block takes (the row tiles of M)
BLOCK_M = 64
#: blocks of a cluster, i.e. K splits at most (the portable cluster size)
MAX_SPLITS = 8
#: blocks a call aims for: one on each of an H100's 132 SMs
TARGET_BLOCKS = 132
_ENTRY = "tst_int4_matmul"


def _check_shapes(y: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, layer: int):
    if y.ndim != 2 or q.ndim != 3 or scale.ndim != 4:
        raise ValueError(f"want y [M, K], q [L, K, N/2], scale [L, K/128, 1, N]; got "
                         f"{tuple(y.shape)}, {tuple(q.shape)}, {tuple(scale.shape)}")
    m, k = y.shape
    n_layers, k2, n_half = q.shape
    if k2 != k or scale.shape != (n_layers, k // GROUP, 1, 2 * n_half) or k % GROUP:
        raise ValueError(f"y {tuple(y.shape)}, q {tuple(q.shape)} and scale "
                         f"{tuple(scale.shape)} do not match (K a multiple of {GROUP})")
    if not 0 <= int(layer) < n_layers:
        raise ValueError(f"layer {layer} is outside the stack of {n_layers}")


def int4_matmul_reference(y: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                          layer: int) -> torch.Tensor:
    """Plain version: dequantize ``q[layer]`` to y's dtype (a materialized
    copy), then ``y @ W`` with f32 products and sums → f32 [M, N]."""
    _check_shapes(y, q, scale, layer)
    ql, sl = q[int(layer)], scale[int(layer)]
    w = torch.cat([_unpack_half(ql, sl, 0, y.dtype), _unpack_half(ql, sl, 1, y.dtype)], dim=-1)
    return y.float() @ w.float()


def check_kernel_args(y: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                      layer: int) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    _check_shapes(y, q, scale, layer)
    if y.shape[0] == 0 or q.shape[2] % NH_MULTIPLE:
        raise ValueError(f"the kernel takes M >= 1 and N/2 a multiple of {NH_MULTIPLE}; got "
                         f"M={y.shape[0]}, N/2={q.shape[2]}")
    device = y.get_device()  # an int: cheaper than comparing torch.device objects
    for name, t, dtype in (("y", y, torch.bfloat16), ("q", q, torch.int8),
                           ("scale", scale, torch.float32)):
        if t.dtype != dtype:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes {dtype}")
        if t.get_device() != device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def split_plan(k: int, n_half: int) -> Tuple[int, int]:
    """(splits, groups per split) of K's 128-row groups for a leaf: enough
    splits that the column blocks of one row tile times the splits come near
    TARGET_BLOCKS, at most MAX_SPLITS (one cluster) and at most one split a
    group; split s takes groups [s·per, min((s + 1)·per, groups)), and none
    is empty.

    The plan takes no M: a row's sum over K runs in the same order whatever
    the number of rows beside it, so a row of speculative decode's verify
    chunk (M = rows · (gamma + 1)) gets the bits of the same row in a greedy
    step (M = rows)."""
    groups = k // GROUP
    blocks = n_half // NH_MULTIPLE
    want = max(1, min(MAX_SPLITS, groups, -(-TARGET_BLOCKS // blocks)))
    per = -(-groups // want)
    return -(-groups // per), per


@functools.lru_cache(maxsize=None)
def _entry():
    """The library's C entry, typed once."""
    fn = getattr(_build.library(), _ENTRY)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return fn


def _launch(y, q, scale, layer: int) -> torch.Tensor:
    """The kernel on checked CUDA tensors → f32 [M, N]."""
    global LAUNCHES
    m, k = y.shape
    n_half = q.shape[2]
    device = y.device
    out = torch.empty((m, 2 * n_half), dtype=torch.float32, device=device)
    err = _entry()(y.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k, n_half,
                   layer, split_plan(k, n_half)[0], device.index,
                   _build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"{_ENTRY} failed with cudaError_t {err} (y {tuple(y.shape)}, "
                           f"q {tuple(q.shape)}, layer {layer})")
    LAUNCHES += 1
    return out


def int4_matmul_stacked(y: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                        layer: int, *, block_n: int = 4096, block_k: int = 1024,
                        pipeline=None) -> torch.Tensor:
    """``y[M, K] @ dequant(q[layer], scale[layer])[K, N]`` → f32 [M, N]: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    ``block_n``, ``block_k`` and ``pipeline`` are the TPU kernel's knobs and
    have no effect here."""
    if y.device.type == "cpu":
        return int4_matmul_reference(y, q, scale, layer)
    if y.device.type != "cuda":
        raise ValueError(f"int4_matmul_stacked: unsupported device {y.device}")
    check_kernel_args(y, q, scale, layer)
    return _launch(y, q, scale, int(layer))


def int4_matmul(y: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                block_n: int = 4096, block_k: int = 1024) -> torch.Tensor:
    """2-D convenience wrapper: ``y[M, K] @ dequant(q, scale)[K, N]``."""
    return int4_matmul_stacked(y, q[None], scale[None], 0)
