"""Weights-only int8 / int4 quantization of the frozen base model
(counterpart of ``tst/models/quant.py``).

The base is never trained, so it is a read-only payload: int8 per output
channel halves it, int4 RTN-g128 on the stacked layer matrices quarters
them. A quantized leaf is ``{"q": int8, "scale": f32}``:

  * int8: symmetric per output channel, ``scale`` ``[..., 1, out]``;
  * int4: symmetric per (128-row input group, output column), ``scale``
    ``[..., in/128, 1, out]`` (one rank above ``q``, which is how a packed
    leaf is recognized). ``q`` ``[..., in, out/2]`` holds two nibbles a
    byte, planar along the output axis: column ``j`` in the low nibble,
    stored biased +8, column ``j + out/2`` in the high nibble, signed, so the
    byte equals ``16·hi + lo_biased``.

Rounding is half-to-even on both sides (``jnp.round``, ``torch.round``) and
every step is an IEEE f32 operation in the reference's order, so ``q`` and
``scale`` are bit-equal to the JAX package's. One detail follows XLA: the
reference quantizes a stacked ``[L, in, out]`` leaf under ``lax.map``, where
XLA folds ``amax / 127`` (``/ 7``) into a product with the f32 reciprocal;
a 2-D leaf is quantized eagerly and divides. The port does the same. Under ``bits=4`` the embedding
and head stay int8 (gathered rows, fidelity-critical), as in the reference.
``quantizing_put`` quantizes an HF checkpoint's tensors as they stream in.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

Params = Dict[str, Any]

#: leaves quantized: the large matmul weights (norms and biases are kept)
_QUANT_KEYS = {"embed", "lm_head", "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
#: leaves that go int4 under bits=4: the stacked layer matrices only
_INT4_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
#: int4 group size along the input axis (RTN-g128)
INT4_GROUP = 128


def _per_layer(fn, w: torch.Tensor):
    """``fn(w2d, stacked)`` on each layer of a stacked [L, in, out] weight (the
    f32 transient is one layer, as the reference's ``lax.map``), else on ``w``."""
    if w.ndim != 3:
        return fn(w, False)
    parts = [fn(w[i], True) for i in range(w.shape[0])]
    return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


def _over(amax: torch.Tensor, c: float, stacked: bool) -> torch.Tensor:
    """amax / c as the reference computes it (module docstring)."""
    return amax * np.float32(1.0 / c) if stacked else amax / c


def quantize_leaf(w: torch.Tensor, bits: int = 8) -> Dict[str, torch.Tensor]:
    """[..., in, out] weight → {"q": int8, "scale": f32}: int4 RTN-g128
    (planar nibbles) when ``bits=4`` and the input axis is a multiple of
    :data:`INT4_GROUP` (and out is even), else int8 per output channel."""
    if (bits == 4 and w.ndim >= 2 and w.shape[-2] % INT4_GROUP == 0
            and w.shape[-1] % 2 == 0):
        return _quantize_leaf_int4(w)
    if bits not in (4, 8):
        raise ValueError(f"quantize_leaf: bits must be 4 or 8, got {bits}")

    def one(w2d, stacked):
        wf = w2d.float()
        amax = wf.abs().amax(dim=-2, keepdim=True) if w2d.ndim >= 2 else wf.abs().amax()
        scale = torch.clamp_min(_over(amax, 127.0, stacked), 1e-12)
        q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
        return q, scale.float()

    q, scale = _per_layer(one, w)
    return {"q": q, "scale": scale}


def _quantize_leaf_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    g = INT4_GROUP

    def one(w2d, stacked):
        n_in, n_out = w2d.shape
        wf = w2d.float().reshape(n_in // g, g, n_out)
        amax = wf.abs().amax(dim=1, keepdim=True)  # [in/g, 1, out]
        scale = torch.clamp_min(_over(amax, 7.0, stacked), 1e-12)
        q = torch.clamp(torch.round(wf / scale), -7, 7).to(torch.int8).reshape(n_in, n_out)
        # planar pack: column j → low nibble (biased +8), j + out/2 → high
        hi, lo = q[:, n_out // 2:].to(torch.int16), q[:, : n_out // 2].to(torch.int16)
        return ((hi << 4) + (lo + 8)).to(torch.int8), scale.float()

    q, scale = _per_layer(one, w)
    return {"q": q, "scale": scale}


def _unpack_half(q: torch.Tensor, scale: torch.Tensor, which: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """One planar nibble half of a packed-int4 leaf, dequantized in f32 and
    cast to ``dtype`` → [..., in, out/2]. ``which``: 0 = low nibbles
    (columns [0, out/2)), 1 = high (columns [out/2, out))."""
    n_groups = scale.shape[-3]
    lead, n_in, n_half = q.shape[:-2], q.shape[-2], q.shape[-1]
    vals = ((q & 0xF) - 8) if which == 0 else (q >> 4)  # arithmetic shift: signed
    s = scale[..., :n_half] if which == 0 else scale[..., n_half:]
    wf = vals.reshape(*lead, n_groups, n_in // n_groups, n_half).float() * s
    return wf.reshape(*lead, n_in, n_half).to(dtype)


def dequantize_leaf(leaf, dtype: torch.dtype) -> torch.Tensor:
    """A plain or quantized leaf in ``dtype`` (the f32 product, then cast)."""
    if is_quantized_leaf(leaf):
        q, scale = leaf["q"], leaf["scale"]
        if scale.ndim == q.ndim + 1:  # packed int4
            return torch.cat([_unpack_half(q, scale, 0, dtype),
                              _unpack_half(q, scale, 1, dtype)], dim=-1)
        return (q.float() * scale).to(dtype)
    return leaf.to(dtype)


def _dot(y: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """y @ w with ``w`` in y's working dtype; an f32 result is the f32
    product of the operands (bf16 values are exact in f32)."""
    if out_dtype == y.dtype:
        return y @ w
    return (y.to(out_dtype) @ w.to(out_dtype)).to(out_dtype)


def qdot(y: torch.Tensor, leaf, dtype: torch.dtype,
         preferred: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y[..., in] @ W[in, out]`` against a plain or quantized 2-D weight
    leaf. Packed-int4 leaves run one product per planar nibble half, then
    one concatenation restores column order. ``dtype`` is the weight's
    working dtype, ``preferred`` the output dtype (default ``dtype``)."""
    preferred = preferred or dtype
    if is_quantized_leaf(leaf) and leaf["q"].ndim == 2 and leaf["scale"].ndim == 3:
        q, scale = leaf["q"], leaf["scale"]
        lo = _dot(y, _unpack_half(q, scale, 0, dtype), preferred)
        hi = _dot(y, _unpack_half(q, scale, 1, dtype), preferred)
        return torch.cat([lo, hi], dim=-1)
    return _dot(y, dequantize_leaf(leaf, dtype), preferred)


def is_quantized_leaf(leaf) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "scale" in leaf


def is_int4_leaf(leaf) -> bool:
    """A packed-int4 leaf (grouped scale one rank above ``q``)."""
    return is_quantized_leaf(leaf) and leaf["scale"].ndim == leaf["q"].ndim + 1


def leaf_bits(leaf_key: str, bits: int) -> int:
    """Bit width of one leaf: under bits=4 only the stacked layer matrices
    go int4; the embedding and head stay int8."""
    return 4 if (bits == 4 and leaf_key in _INT4_KEYS) else 8


def quantize_params(params: Params, bits: int = 8) -> Params:
    """Quantize the big matrices of a base tree IN PLACE, leaf by leaf (each
    source leaf is dropped as its replacement lands), and return it."""

    def walk(node):
        for key, child in node.items():
            if isinstance(child, dict) and not is_quantized_leaf(child):
                walk(child)
            elif key in _QUANT_KEYS and not is_quantized_leaf(child):
                node[key] = quantize_leaf(child, bits=leaf_bits(key, bits))
        return node

    return walk(params)


def quantizing_put(dtype=torch.bfloat16, device=None, bits: int = 8):
    """A ``put`` for tst_torch.models.hf_load.load_checkpoint that quantizes
    each streamed tensor on arrival, on ``device`` (default: where the
    tensor already is): the model never exists in ``dtype`` at once. A layer
    tensor arrives as a [1, in, out] slice and is quantized as one layer of
    a stack, as the reference's ``lax.map`` quantizes it, so ``q`` and
    ``scale`` are bit-equal to the reference's."""

    def put(path: str, t: torch.Tensor) -> Any:
        leaf_key = path.split(".")[-1]
        x = t.to(device=device if device is not None else t.device, dtype=dtype)
        if leaf_key in _QUANT_KEYS:
            return quantize_leaf(x, bits=leaf_bits(leaf_key, bits))
        return x

    return put


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def quantized_bytes(params: Params) -> int:
    """Bytes of a plain or quantized tree (int4 is already packed in int8)."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def leaf_logical_shape(leaf) -> tuple:
    """Pre-quantization shape of a plain or quantized leaf."""
    if not is_quantized_leaf(leaf):
        return tuple(leaf.shape)
    q = leaf["q"]
    if is_int4_leaf(leaf):
        return (*q.shape[:-1], 2 * q.shape[-1])
    return tuple(q.shape)
