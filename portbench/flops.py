"""The benchmark's own count of operations and bytes, and the card's peaks.

Every count is the standard 2·m·n·k of a product, from the configuration's
published widths and the traffic's shapes; elementwise work (norms, RoPE,
softmax, SwiGLU's gate, the optimizer) is not counted.

* :func:`train_step_flops` and :func:`score_call_flops` are model FLOPs: the
  work the step needs, in **every** layer, without remat's recomputation and
  without the attention backward's recomputation of Q·Kᵀ. The base is
  frozen, so the backward runs the products that carry the gradient to the
  adapters (dgrad) and no weight gradient of the base; the first layer's
  q, k and v products need no dgrad (their input comes from the frozen
  embedding).
* :func:`attention_bounds` is what one call of each attention kernel needs,
  with the recomputation the kernel's algorithm cannot avoid (the dK/dV and
  dQ kernels form P again from Q·Kᵀ): the least time the card could take
  for it, the larger of operations over the bf16 peak and bytes (each input
  read once, each output written once) over the memory rate.
"""

from __future__ import annotations

from typing import Dict, Mapping

#: NVIDIA H100 SXM, dense bf16 (NVIDIA's data sheet, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
#: NVIDIA H100 SXM HBM3 (the data sheet)
PEAK_BYTES_PER_S = 3.35e12

#: LoRA target name → (input width, output width) attribute of :func:`widths`
_TARGETS = {"q_proj": ("d", "q"), "k_proj": ("d", "kv"), "v_proj": ("d", "kv"),
            "o_proj": ("q", "d"), "gate_proj": ("d", "f"), "up_proj": ("d", "f"),
            "down_proj": ("f", "d")}
#: targets whose input is the layer's normed input (no dgrad in layer 0)
_FROM_LAYER_INPUT = ("q_proj", "k_proj", "v_proj")


def widths(cfg: Mapping) -> Dict[str, int]:
    """The widths of a configuration file (HF config.json keys)."""
    heads = int(cfg["num_attention_heads"])
    dh = int(cfg.get("head_dim") or cfg["hidden_size"] // heads)
    return {"d": int(cfg["hidden_size"]), "L": int(cfg["num_hidden_layers"]), "H": heads,
            "KVH": int(cfg["num_key_value_heads"]), "dh": dh, "q": heads * dh,
            "kv": int(cfg["num_key_value_heads"]) * dh, "f": int(cfg["intermediate_size"]),
            "V": int(cfg["vocab_size"])}


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal row of ``s`` tokens keeps, the diagonal
    included."""
    return s * (s + 1) // 2


def _base_per_token(w: Mapping[str, int]) -> int:
    """Multiply-adds a token a layer in the base projections: q, k, v, o and
    SwiGLU's gate, up and down."""
    d = w["d"]
    return d * w["q"] + 2 * d * w["kv"] + w["q"] * d + 3 * d * w["f"]


def _lora_fwd_per_token(w: Mapping[str, int], lora: Mapping) -> int:
    """Multiply-adds a token a layer of the adapters' forward, (x·Aᵀ)·Bᵀ."""
    r = int(lora["rank"])
    return sum(r * (w[_TARGETS[t][0]] + w[_TARGETS[t][1]]) for t in lora["targets"])


def attention_fwd_flops(w: Mapping[str, int], rows: int, s: int) -> float:
    """One layer's causal attention forward: Q·Kᵀ and P·V over the kept
    pairs, 2·dh operations a pair each."""
    return 4.0 * w["dh"] * w["H"] * causal_pairs(s) * rows


def train_step_flops(cfg: Mapping, traffic: Mapping) -> float:
    """Model FLOPs of one fold-parallel LoRA step of ``traffic``: k·B rows of
    S tokens, the answer-window head over ``t_max`` positions a row."""
    w = widths(cfg)
    rows = int(traffic["folds"]) * int(traffic["rows_per_fold"])
    s, t_max, lora = int(traffic["seq_len"]), int(traffic["t_max"]), traffic["lora"]
    tokens = rows * s
    fwd = 2.0 * _base_per_token(w) * w["L"] * tokens
    dgrad = fwd - 2.0 * w["d"] * (w["q"] + 2 * w["kv"]) * tokens
    attn_fwd = attention_fwd_flops(w, rows, s) * w["L"]
    attn_bwd = 2.0 * attn_fwd  # dV = Pᵀ·dO, dP = dO·Vᵀ, dQ = dS·K, dK = dSᵀ·Q
    lora_fwd = 2.0 * _lora_fwd_per_token(w, lora) * w["L"] * tokens
    r = int(lora["rank"])
    layer0_dx = sum(2.0 * r * w[_TARGETS[t][0]] * tokens for t in lora["targets"]
                    if t in _FROM_LAYER_INPUT)
    lora_bwd = 2.0 * lora_fwd - layer0_dx  # dB, dA, dZ = dY·B, dX = dZ·A
    head = 2.0 * w["d"] * w["V"] * t_max * rows  # the window's logits
    return fwd + dgrad + attn_fwd + attn_bwd + lora_fwd + lora_bwd + 2.0 * head


def score_call_flops(cfg: Mapping, traffic: Mapping) -> float:
    """Model FLOPs of one scoring call: the forward of ``rows_per_call`` rows
    of S tokens through their fold's adapter, and the letter columns of the
    head at each row's answer position."""
    w = widths(cfg)
    rows, s = int(traffic["rows_per_call"]), int(traffic["seq_len"])
    tokens = rows * s
    fwd = 2.0 * _base_per_token(w) * w["L"] * tokens
    lora_fwd = 2.0 * _lora_fwd_per_token(w, traffic["lora"]) * w["L"] * tokens
    attn = attention_fwd_flops(w, rows, s) * w["L"]
    return fwd + lora_fwd + attn + 2.0 * w["d"] * int(traffic["letters"]) * rows


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations over the bf16 peak or
    bytes over the memory rate, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S)


def attention_bounds(w: Mapping[str, int], rows: int, s: int) -> Dict[str, Dict[str, float]]:
    """Operations, bytes and bound seconds of one call of the causal
    forward, dK/dV and dQ kernels at q [rows, s, H, dh], k and v [rows, s,
    KVH, dh] in bf16, with f32 row statistics (lse, and di in the backward):
    forward Q·Kᵀ, P·V; dK/dV S = Q·Kᵀ again, dP, dV, dK; dQ S, dP, dQ."""
    pairs = causal_pairs(s) * w["H"] * rows
    qb = rows * s * w["q"] * 2  # q, o, do or dq
    kvb = 2 * rows * s * w["kv"] * 2  # k and v, or dk and dv
    stat = rows * w["H"] * s * 4
    out = {}
    for name, ops, nbytes in (("fwd", 4 * w["dh"] * pairs, 2 * qb + kvb + stat),
                              ("dkv", 8 * w["dh"] * pairs, 2 * qb + 2 * kvb + 2 * stat),
                              ("dq", 6 * w["dh"] * pairs, 3 * qb + kvb + 2 * stat)):
        out[name] = {"flops": float(ops), "bytes": float(nbytes),
                     "seconds": bound_seconds(ops, nbytes)}
    return out
