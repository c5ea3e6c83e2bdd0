"""LoRA adapters, single or fold-stacked (counterpart of ``tst/models/lora.py``).

An adapter tree is ``{proj: {"a": [L, r, in], "b": [L, out, r]}}`` with the
decoder's projection names ("q", "k", "v", "o", "gate", "up", "down"). The
fold-parallel trainer stacks k of them on a leading fold axis: ``a``
``[k, L, r, in]``, ``b`` ``[k, L, out, r]``. With a fold-stacked adapter the
decoder takes fold-major rows ``[k·B, S]``, runs every base projection once
on all of them and the adapters as a product batched over the fold axis, so
the frozen base exists once. B starts at zero, so a new adapter leaves the
base model's output unchanged. The delta is computed as ``(x·Aᵀ)·Bᵀ`` and
never as a dense ``Aᵀ·Bᵀ``.

LoRA dropout (``LoraSpec.dropout``) is inverted dropout on the adapter
input, in training only: the base path is untouched, and serving passes no
:class:`DropoutKey`, so it never drops. A mask is a function of (fold,
optimizer step, layer, projection) alone, drawn from a ``torch.Generator``
on the run's device seeded from that tuple (:func:`dropout_mask`). The
reference folds the same tuple into a ``jax.random`` key; its threefry
stream is not reproduced here, so tests inject its masks through
``DropoutKey.masks``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

#: target name → (input dim attr, output dim attr) of the decoder layer
_TARGET_DIMS = {
    "q_proj": ("d_model", "q_dim"),
    "k_proj": ("d_model", "kv_dim"),
    "v_proj": ("d_model", "kv_dim"),
    "o_proj": ("q_dim", "d_model"),
    "gate_proj": ("d_model", "d_ff"),
    "up_proj": ("d_model", "d_ff"),
    "down_proj": ("d_ff", "d_model"),
}

#: decoder-internal projection name → LoRA target name
PROJ_TO_TARGET = {
    "q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj",
    "gate": "gate_proj", "up": "up_proj", "down": "down_proj",
}
_TARGET_TO_PROJ = {t: p for p, t in PROJ_TO_TARGET.items()}

#: the reference's stable projection ids for dropout masks
#: (tst/models/decoder.py:131)
PROJ_IDS = {n: i for i, n in enumerate(("q", "k", "v", "o", "gate", "up", "down"))}
#: the reference's root key of the dropout masks (tst/train/sft.py:340)
DROPOUT_ROOT = 0x10A0


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    dtype: torch.dtype = torch.bfloat16
    #: train-time inverted dropout on the adapter input (the reference's)
    dropout: float = 0.0

    def __post_init__(self):
        bad = set(self.targets) - set(_TARGET_DIMS)
        if bad:
            raise ValueError(f"unknown LoRA targets {sorted(bad)}; have {sorted(_TARGET_DIMS)}")


def lora_scale(spec: LoraSpec) -> float:
    return spec.alpha / spec.rank


def lora_shapes(model_spec, spec: LoraSpec) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """``{proj: {"a": (L, r, in), "b": (L, out, r)}}`` in ``spec.targets``'
    order: the shapes of one adapter."""
    out: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for target in spec.targets:
        in_attr, out_attr = _TARGET_DIMS[target]
        d_in, d_out = getattr(model_spec, in_attr), getattr(model_spec, out_attr)
        out[_TARGET_TO_PROJ[target]] = {"a": (model_spec.n_layers, spec.rank, d_in),
                                        "b": (model_spec.n_layers, d_out, spec.rank)}
    return out


def init_lora(rng: torch.Generator, model_spec, spec: LoraSpec) -> Params:
    """Adapter tree ``{proj: {"a": [L, r, in], "b": [L, out, r]}}`` on
    ``rng.device``: A ~ N(0, 1)/sqrt(in), B = 0. The numbers differ from the
    JAX package's (another generator); tests carry JAX adapters across
    through tst_torch.bridge instead."""
    out: Params = {}
    for proj, shapes in lora_shapes(model_spec, spec).items():
        a = torch.randn(shapes["a"], generator=rng, device=rng.device)
        out[proj] = {
            "a": (a / np.sqrt(shapes["a"][-1])).to(spec.dtype),
            "b": torch.zeros(shapes["b"], dtype=spec.dtype, device=rng.device),
        }
    return out


def fold_count(lora: Optional[Params]) -> Optional[int]:
    """k for a fold-stacked adapter (leaves ``[k, L, ...]``), None for a
    single adapter or none."""
    if not lora:
        return None
    a = next(iter(lora.values()))["a"]
    return a.shape[0] if a.ndim == 4 else None


def layer_slice(lora: Params, i: int) -> Params:
    """Layer ``i`` of a single or fold-stacked adapter tree."""
    return {p: {n: t.select(t.ndim - 3, i) for n, t in ab.items()} for p, ab in lora.items()}


def _mix64(z: int) -> int:
    """splitmix64's finalizer: a well-spread 64-bit value of ``z``."""
    z &= (1 << 64) - 1
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return z ^ (z >> 31)


def dropout_seed(fold: int, step: int, layer: int, proj: str) -> int:
    """The generator seed of one mask: the tuple (root, fold, step, layer,
    projection id) mixed into 63 bits."""
    z = DROPOUT_ROOT
    for part in (fold, step, layer, PROJ_IDS[proj]):
        z = _mix64(z * 0x9E3779B97F4A7C15 + int(part) + 1)
    return z >> 1


def dropout_mask(fold: int, step: int, layer: int, proj: str, shape, keep: float,
                 device) -> torch.Tensor:
    """Bool keep-mask of ``shape``: uniform draws below ``keep`` from a
    generator on ``device`` seeded by :func:`dropout_seed`, so the same
    tuple gives the same mask wherever it is drawn again (a recomputing
    backward included)."""
    g = torch.Generator(device=device).manual_seed(dropout_seed(fold, step, layer, proj))
    return torch.rand(shape, generator=g, device=device) < keep


#: ``(fold, step, layer, proj, shape, keep, device) -> bool mask``
MaskFn = Callable[..., torch.Tensor]


@dataclasses.dataclass(frozen=True)
class DropoutKey:
    """The seed of one train step's LoRA dropout (the port's ``lora_rng``):
    the fold of each fold-major row block and the optimizer step; the
    decoder adds the layer and the projection (:meth:`at`). ``masks``
    draws a block's mask; :func:`dropout_mask` unless a caller injects
    another (the parity tests inject the reference's).

    Under a mesh a rank's input is a window of the one-process input, and
    its mask the same window of the one-process mask: ``rows`` (share,
    shares) of each fold block's rows over ``data``, ``seq`` (start, full
    length) of the sequence under the ring, ``cols`` (start, full width)
    of a row-parallel projection's input over ``tensor``."""

    folds: Tuple[int, ...]
    step: int
    masks: MaskFn = dropout_mask
    layer: Optional[int] = None
    proj: Optional[str] = None
    rows: Optional[Tuple[int, int]] = None
    seq: Optional[Tuple[int, int]] = None
    cols: Optional[Tuple[int, int]] = None

    def at(self, layer: int, proj: str) -> "DropoutKey":
        return dataclasses.replace(self, layer=layer, proj=proj)

    def mask(self, shape, keep: float, device) -> torch.Tensor:
        """The keep-mask of an input of ``shape`` [k·B, S, in], fold block by
        fold block (and, under a mesh, this rank's window of it)."""
        blocks = len(self.folds)
        if shape[0] % blocks:
            raise ValueError(f"{shape[0]} rows do not split into {blocks} fold blocks")
        rows = shape[0] // blocks
        share, shares = self.rows or (0, 1)
        s0, s_full = self.seq or (0, shape[1])
        c0, c_full = self.cols or (0, shape[-1])
        block = (rows * shares,) + tuple(shape[1:-1]) + (c_full,)
        if len(block) > 2:
            block = (block[0], s_full) + block[2:]
        out = []
        for f in self.folds:
            m = self.masks(f, self.step, self.layer, self.proj, block, keep, device)
            m = m[share * rows: (share + 1) * rows]
            if m.ndim > 2:
                m = m[:, s0: s0 + shape[1]]
            out.append(m[..., c0: c0 + shape[-1]])
        return torch.cat(out)


def apply_lora_delta(layer_lora: Params, x: torch.Tensor, spec: LoraSpec,
                     rng: Optional[DropoutKey] = None) -> torch.Tensor:
    """Per-layer delta ``scale · (x·Aᵀ)·Bᵀ`` in x's dtype. x: [B, S, in] →
    [B, S, out].

    ``layer_lora`` holds this layer's slices: a [r, in], b [out, r], or
    fold-stacked a [k, r, in], b [k, out, r] with x's rows fold-major
    (B = k·B_fold). ``rng`` (a :class:`DropoutKey` at this layer and
    projection) with ``spec.dropout > 0`` drops the adapter's input:
    ``where(mask, x / keep, 0)`` in x's dtype. Without it, no dropout."""
    if rng is not None and spec.dropout > 0.0:
        keep = 1.0 - spec.dropout
        mask = rng.mask(x.shape, keep, x.device)
        x = torch.where(mask, x / torch.tensor(keep, dtype=x.dtype), torch.zeros((), dtype=x.dtype))
    a, b = layer_lora["a"].to(x.dtype), layer_lora["b"].to(x.dtype)
    xs = x.reshape(a.shape[0], -1, x.shape[-1]) if a.ndim == 3 else x
    d = (xs @ a.mT) @ b.mT
    return d.reshape(*x.shape[:-1], b.shape[-2]) * torch.tensor(lora_scale(spec), dtype=x.dtype)


def merge_lora(params: Params, lora: Params, spec: LoraSpec) -> Params:
    """Fold a single adapter into the base weights: w += scale·Aᵀ·Bᵀ (f32
    sum, cast back to w's dtype)."""
    name_map = {"q": "wq", "k": "wk", "v": "wv", "o": "wo",
                "gate": "w_gate", "up": "w_up", "down": "w_down"}
    merged = dict(params)
    merged["layers"] = dict(params["layers"])
    for proj, ab in lora.items():
        w = params["layers"][name_map[proj]]
        delta = torch.einsum("lri,lor->lio", ab["a"].float(), ab["b"].float()) * lora_scale(spec)
        merged["layers"][name_map[proj]] = (w.float() + delta).to(w.dtype)
    return merged


def lora_param_count(lora: Params) -> int:
    return sum(t.numel() for ab in lora.values() for t in ab.values())
