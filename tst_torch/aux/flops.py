"""Analytic FLOPs of the fold-parallel train step (a copy of
``tst/aux/flops.py``, whose module imports jax).

The standard 2·m·n·k count from the model's geometry:

  * ``model_flops``: the MFU convention, forward and backward of the model's
    matmuls without remat's recomputation. The base is frozen (LoRA-only
    training), so the backward runs one dgrad product a base product (no
    wgrad): backward ≈ forward;
  * ``hardware_flops``: what the card runs, with the recomputation of the
    ``remat`` mode added;
  * ``fwd_flops``: the forward's matmuls and attention.

The mode arithmetic is the reference's. On the port, "dots_attn" keeps the
attention kernel's output and lse as "dots_flash" does
(tst_torch.models.decoder ``_remat_layer``), so it re-runs no kernel; the
count here stays the reference's, as the copy is held to it.
"""

from __future__ import annotations

from typing import Dict

from tst_torch.models.lora import LoraSpec
from tst_torch.models.spec import ModelSpec


def train_step_flops(
    spec: ModelSpec,
    lora_spec: LoraSpec,
    n_rows: int,
    seq: int,
    t_max: int,
    remat=False,
) -> Dict[str, float]:
    """FLOPs of one fold-parallel train step over ``n_rows`` sequences
    (n_rows = k · batch per fold: every fold's rows run the same step)."""
    d, q, kv = spec.d_model, spec.q_dim, spec.n_kv_heads * spec.d_head
    f, L, v = spec.d_ff, spec.n_layers, spec.vocab_size
    tokens = n_rows * seq

    # per-token per-layer matmul params: qkvo + SwiGLU gate/up/down
    m_layer = 2 * d * q + 2 * d * kv + 3 * d * f
    fwd_matmul = 2.0 * m_layer * L * tokens

    # causal attention: qk^T and pv, each 2*S*(H*dh) per token, half masked
    attn_fwd = 2.0 * 2 * q * seq * 0.5 * tokens
    # the flash backward recomputes probabilities and runs dQ/dKV/dV ~ 2.5x fwd
    attn_bwd = 2.5 * attn_fwd

    # LoRA adapters: fwd + dgrad + wgrad (adapters do take weight grads)
    lora_dims = {"q_proj": (d, q), "k_proj": (d, kv), "v_proj": (d, kv),
                 "o_proj": (q, d), "gate_proj": (d, f), "up_proj": (d, f),
                 "down_proj": (f, d)}
    r = lora_spec.rank
    m_lora = sum(r * (lora_dims[t][0] + lora_dims[t][1])
                 for t in lora_spec.targets if t in lora_dims)
    lora_flops = 3 * 2.0 * m_lora * L * tokens

    # answer-window head: t_max positions per row, fwd + dgrad
    head_flops = 2 * 2.0 * d * v * t_max * n_rows

    model = (2 * fwd_matmul        # fwd + dgrad (frozen base: no wgrad)
             + attn_fwd + attn_bwd + lora_flops + head_flops)
    hardware = model
    if remat is True:  # full remat: one extra forward during backward
        hardware = model + fwd_matmul + attn_fwd
    elif remat in ("dots", "dots_attn"):
        # dots saves matmul outputs but not the flash residuals: the flash
        # forward re-runs during backward
        hardware = model + attn_fwd
    elif remat == "light":
        # save-all-but-MLP-hiddens: backward re-runs gate/up matmuls + silu
        hardware = model + 2.0 * (2 * d * f) * L * tokens
    elif remat == "attn":
        # saves q/k/v + flash residuals; backward re-runs the o-projection and
        # the MLP matmuls
        hardware = model + 2.0 * (d * q + 3 * d * f) * L * tokens
    # "dots_flash" and False recompute no matmuls and no flash kernels
    return {"model_flops": model, "hardware_flops": hardware,
            "fwd_flops": fwd_matmul + attn_fwd}
