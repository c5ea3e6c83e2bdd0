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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

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

#: where LoRA dropout is still to be ported
DROPOUT_ITEM = "ROADMAP item 5"


@dataclasses.dataclass(frozen=True)
class LoraSpec:
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("q_proj", "k_proj", "v_proj", "o_proj")
    dtype: torch.dtype = torch.bfloat16
    #: train-time inverted dropout on the adapter input (the reference's);
    #: training with dropout > 0 is not ported yet and raises
    dropout: float = 0.0

    def __post_init__(self):
        bad = set(self.targets) - set(_TARGET_DIMS)
        if bad:
            raise ValueError(f"unknown LoRA targets {sorted(bad)}; have {sorted(_TARGET_DIMS)}")


def lora_scale(spec: LoraSpec) -> float:
    return spec.alpha / spec.rank


def init_lora(rng: torch.Generator, model_spec, spec: LoraSpec) -> Params:
    """Adapter tree ``{proj: {"a": [L, r, in], "b": [L, out, r]}}`` on
    ``rng.device``: A ~ N(0, 1)/sqrt(in), B = 0. The numbers differ from the
    JAX package's (another generator); tests carry JAX adapters across
    through tst_torch.bridge instead."""
    n_layers = model_spec.n_layers
    out: Params = {}
    for target in spec.targets:
        in_attr, out_attr = _TARGET_DIMS[target]
        d_in, d_out = getattr(model_spec, in_attr), getattr(model_spec, out_attr)
        a = torch.randn((n_layers, spec.rank, d_in), generator=rng, device=rng.device)
        out[_TARGET_TO_PROJ[target]] = {
            "a": (a / np.sqrt(d_in)).to(spec.dtype),
            "b": torch.zeros((n_layers, d_out, spec.rank), dtype=spec.dtype,
                             device=rng.device),
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


def apply_lora_delta(layer_lora: Params, x: torch.Tensor, spec: LoraSpec,
                     rng: Optional[torch.Generator] = None) -> torch.Tensor:
    """Per-layer delta ``scale · (x·Aᵀ)·Bᵀ`` in x's dtype. x: [B, S, in] →
    [B, S, out].

    ``layer_lora`` holds this layer's slices: a [r, in], b [out, r], or
    fold-stacked a [k, r, in], b [k, out, r] with x's rows fold-major
    (B = k·B_fold). ``rng`` (train-time dropout) raises: LoRA dropout is not
    ported yet."""
    if rng is not None and spec.dropout > 0.0:
        raise NotImplementedError(f"LoRA dropout is not ported to tst_torch yet ({DROPOUT_ITEM})")
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
