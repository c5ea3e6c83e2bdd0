"""Decoder-only LM: RMSNorm + RoPE + GQA attention + SwiGLU, with LoRA.

Counterpart of ``tst/models/decoder.py:155-582``. The parameter tree has the
reference's keys and layout: nested dicts of tensors, per-layer weights
stacked on a leading ``[n_layers, ...]`` axis, linear weights stored
``[in, out]``. The layer loop is a Python loop over that axis. Matmuls run
in ``spec.dtype`` with f32 accumulation (the device module turns
reduced-precision reductions off); norms, softmax statistics and the head's
output are f32. The base weights are never trained; gradients flow to LoRA
adapters (``lora=``, tst_torch.models.lora), single or fold-stacked.

Attention: ``use_pallas=True`` goes through ``tst_torch.kernels.flash_attention``
(the CUDA kernels, forward and backward, for CUDA tensors, their plain
versions for CPU tensors); ``use_pallas=False`` takes the dense path.
Packed rows (``seg_starts``) confine attention to each sample's segment
and restart RoPE positions at each segment start. With ``use_pallas`` and
``fused_mlp`` the MLP goes through ``tst_torch.kernels.fused_mlp`` (the CUDA
kernel K4) when no adapter targets it, as in the reference.

Weight leaves may be quantized (tst_torch.models.quant: int8, or packed
int4 on the layer matrices): projections go through ``qdot``, the embedding
gathers int8 rows and dequantizes only those, and the head is dequantized.

``remat`` recomputes each layer in the backward instead of keeping its
activations (``torch.utils.checkpoint``, non-reentrant, one region a layer
or sub-layer regions): :func:`_remat_layer` maps the reference's seven
modes. A mode changes what is saved, never a number.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts, noop_context_fn)

from tst_torch.kernels.flash_attention import (flash_attention, masked_attention,
                                                segment_mask, segment_starts_per_pos)
from tst_torch.kernels.fused_mlp import fused_swiglu_mlp
from tst_torch.models.lora import DropoutKey, apply_lora_delta, fold_count, layer_slice
from tst_torch.models.quant import dequantize_leaf, is_quantized_leaf, qdot
from tst_torch.models.spec import ModelSpec
from tst_torch.runtime import mesh as mesh_mod

Params = Dict[str, Any]


def init_params(rng: torch.Generator, spec: ModelSpec) -> Params:
    """Random init (scaled normal) on ``rng.device``. The numbers differ from
    the JAX package's (another generator); tests carry JAX weights across
    through tst_torch.bridge instead."""
    d, L, dt = spec.d_model, spec.n_layers, spec.dtype
    device = rng.device

    def dense(shape, fan_in):
        w = torch.randn(shape, generator=rng, device=device, dtype=torch.float32)
        return (w / np.sqrt(fan_in)).to(dt)

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    embed = dense((spec.vocab_size, d), d)
    layers = {
        "attn_norm": ones((L, d)),
        "wq": dense((L, d, spec.q_dim), d),
        "wk": dense((L, d, spec.kv_dim), d),
        "wv": dense((L, d, spec.kv_dim), d),
        "wo": dense((L, spec.q_dim, d), spec.q_dim),
        "mlp_norm": ones((L, d)),
        "w_gate": dense((L, d, spec.d_ff), d),
        "w_up": dense((L, d, spec.d_ff), d),
        "w_down": dense((L, spec.d_ff, d), spec.d_ff),
    }
    if spec.qkv_bias:
        layers["bq"] = torch.zeros((L, spec.q_dim), dtype=dt, device=device)
        layers["bk"] = torch.zeros((L, spec.kv_dim), dtype=dt, device=device)
        layers["bv"] = torch.zeros((L, spec.kv_dim), dtype=dt, device=device)
    params: Params = {"embed": embed, "layers": layers, "final_norm": ones((d,))}
    if not spec.tie_embeddings:
        params["lm_head"] = dense((d, spec.vocab_size), d)
    return params


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 statistics, the weight multiplied in f32, output in x.dtype."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * scale * weight.float()).to(x.dtype)


def rope_tables(seq_len: int, d_head: int, theta: float,
                scaling: Optional[tuple] = None,
                device: torch.device | str = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [S, d_head//2] (HF split-half convention), computed in
    float64 numpy exactly as the reference does, then f32 on ``device``.
    ``scaling``: ("llama3", factor, low_freq_factor, high_freq_factor,
    original_ctx), HF's ``rope_type="llama3"``."""
    inv_freq = 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64) / d_head))
    if scaling is not None:
        kind, factor, low_f, high_f, orig_ctx = scaling
        if kind != "llama3":
            raise ValueError(f"unknown rope scaling {kind!r}")
        wavelen = 2.0 * np.pi / inv_freq
        low_wl = orig_ctx / low_f
        high_wl = orig_ctx / high_f
        smooth = (orig_ctx / wavelen - low_f) / (high_f - low_f)
        smoothed = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(wavelen > low_wl, inv_freq / factor,
                            np.where(wavelen < high_wl, inv_freq, smoothed))
    angles = np.outer(np.arange(seq_len, dtype=np.float64), inv_freq)  # [S, dh/2]
    return (torch.from_numpy(np.cos(angles).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(angles).astype(np.float32)).to(device))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, dh]; rotate the two halves (HF non-interleaved layout).
    cos/sin: [S, dh/2] shared tables, or [B, S, dh/2] per-row tables (packed
    rows gather them at per-segment positions); cast to x.dtype before the
    multiply."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = (cos[None] if cos.ndim == 2 else cos)[:, :, None, :].to(x.dtype)
    s = (sin[None] if sin.ndim == 2 else sin)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _dense_attention(q, k, v, causal_mask):
    """Plain attention. q: [B,S,H,dh]; k/v: [B,S,K,dh] (GQA);
    ``causal_mask``: bool [S, S] shared, or [B, S, S] per row (packed)."""
    return masked_attention(q, k, v, causal_mask)[0]


def _flash_attention(q, k, v, seg_starts=None):
    return flash_attention(q, k, v, causal=True, seg_starts=seg_starts)[0]


#: projection name → its bias key (Qwen2-style QKV biases)
_BIAS_KEYS = {"q": "bq", "k": "bk", "v": "bv"}

#: the products a "dots" mode keeps (the reference's ``dots_saveable``):
#: every matmul the layer's projections, adapters and dense attention run
_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.baddbmm.default}
#: the attention kernel's forward operator, whose (output, lse) are its residuals
_FLASH_FWD = torch.ops.tst_torch.flash_attention_fwd.default
#: selective-checkpoint modes → the operators whose outputs they keep
_SAVED_OPS = {"flash": {_FLASH_FWD}, "dots": _DOTS, "dots_flash": _DOTS | {_FLASH_FWD},
              "dots_attn": _DOTS | {_FLASH_FWD}}


def check_remat(remat) -> None:
    """Raise the reference's ValueError on an unknown ``remat`` mode."""
    if remat is False or remat is None:
        return
    if remat is True or remat in ("full", "dots", "dots_attn", "dots_flash", "light", "attn",
                                  "flash"):
        return
    raise ValueError(f"unknown remat mode {remat!r}; use True/'full', 'dots', 'dots_attn', "
                     "'dots_flash', 'light', 'attn', or 'flash'")


def _keep(saved_ops):
    """A selective-checkpoint policy: keep the outputs of ``saved_ops``,
    recompute every other operator."""

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def _ckpt(fn: Callable, *args, context_fn=noop_context_fn):
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context_fn)


def _remat_layer(remat, stages, x):
    """One layer, (x_out, k, v), under ``remat``. ``stages`` are the layer's
    parts: ``attn_in(x) → (q, k, v)`` (norm, projections, RoPE),
    ``attend(q, k, v) → attn`` (the kernel or the dense path), ``rest(x,
    attn) → x_out`` (o-projection and residual, then the MLP block), and
    ``use_pallas``. Each mode against the reference's
    (tst/models/decoder.py:274-319), which names what it saves:

      * True / "full": one region a layer; the layer's input only.
      * "flash": one region, and the kernel's (output, lse) kept by a
        selective-checkpoint policy, so the backward does not run the
        forward kernel again. The dense path has no kernel: "full".
      * "dots": one region keeping every matmul's output; the kernel's
        forward runs again in the backward, as in the reference.
      * "dots_flash": "dots" and the kernel's (output, lse).
      * "dots_attn": the reference keeps dots and the attention output and
        still re-runs the kernel for its lse. The kernel's operator gives
        both outputs at once, so the port keeps "dots_flash"'s set: the lse
        adds 1/(2·D) of the output's bytes, and the kernel is not re-run.
        On the dense path the attention output is a matmul's (P·V), which
        "dots" keeps already.
      * "attn": the post-RoPE q, k and v, the attention output and the
        kernel's (output, lse): ``attn_in`` and ``rest`` are regions of
        their own, the kernel between them keeps its inputs and outputs
        for its backward (on the dense path the attention is a region
        too, saving q, k and v and recomputing the softmax).
      * "light": everything but the MLP's gate, up and activation:
        ``rest`` runs its MLP's gate, up, activation and down product as
        one region from the normed input (the down product runs again
        in the backward, beside the reference's recomputed gate and up).
    """
    attn_in, attend, rest, use_pallas = stages
    if remat in _SAVED_OPS:
        return _ckpt(lambda t: _plain_layer(stages, t), x, context_fn=_keep(_SAVED_OPS[remat]))
    if remat == "attn":
        q, k, v = _ckpt(attn_in, x)
        attn = attend(q, k, v) if use_pallas else _ckpt(attend, q, k, v)
        return _ckpt(rest, x, attn), k, v
    if remat == "light":
        return _plain_layer(stages, x)  # the MLP's region is in ``rest``
    return _ckpt(lambda t: _plain_layer(stages, t), x)  # True / "full"


def _plain_layer(stages, x):
    attn_in, attend, rest, _ = stages
    q, k, v = attn_in(x)
    return rest(x, attend(q, k, v)), k, v


#: projection name → its weight key
_W_KEYS = {"q": "wq", "k": "wk", "v": "wv", "o": "wo", "gate": "w_gate", "up": "w_up",
           "down": "w_down"}


def make_proj(lw, la, i: int, lora_spec, dtype: torch.dtype, mesh=None,
              drop: Optional[DropoutKey] = None, base_dot: Optional[Callable] = None,
              lora_delta: Optional[Callable] = None) -> Callable:
    """``proj(name, y)``: layer ``i``'s projection ``name`` of ``y``, its
    adapter's delta added before its bias, in ``dtype``. The one place the
    tensor and FSDP projections are written; :func:`apply_model` and the
    decode step (tst_torch.models.decode) both call it.

    ``lw`` / ``la`` are the layer's weights and adapters as this rank holds
    them (``mesh``, tst_torch.runtime.mesh). Under ``data`` each weight is
    an FSDP shard, gathered for the product and freed after
    (``fsdp_apply``). Under ``tensor`` q, k, v, gate and up are
    column-parallel (local heads, local ffn; the caller passes ``y``
    through ``to_tensor``) and o and down row-parallel: the local input
    columns against the weight's local rows and A's local columns, the
    partial sums added over the axis (``from_tensor``); an int4 shard whose
    rows split a 128-row group takes its input padded with zero columns to
    the whole groups it holds (``pad_rows``). ``base_dot(y,
    leaf)`` is the base product (``qdot`` by default), ``lora_delta(ab, y,
    rng)`` the adapter's (``apply_lora_delta`` by default)."""
    if base_dot is None:
        def base_dot(y, leaf):
            return qdot(y, leaf, dtype)
    if lora_delta is None:
        def lora_delta(ab, y, rng):
            return apply_lora_delta(ab, y, lora_spec, rng=rng)
    split = mesh is not None and mesh.size("tensor") > 1

    def proj(name: str, y: torch.Tensor) -> torch.Tensor:
        w_key = _W_KEYS[name]
        leaf = lw[w_key]
        out = mesh_mod.fsdp_apply(base_dot, mesh_mod.pad_rows(y, leaf), leaf,
                                  mesh_mod.leaf_pspec(f"layers.{w_key}", leaf), mesh)
        if name in la:
            ab = la[name]
            rng = drop.at(i, name) if drop is not None else None
            if split and name in mesh_mod.ROW_PARALLEL:
                c0 = mesh.index("tensor") * y.shape[-1]
                ab = {"a": ab["a"][..., c0: c0 + y.shape[-1]], "b": ab["b"]}
                if rng is not None:
                    rng = dataclasses.replace(
                        rng, cols=(c0, y.shape[-1] * mesh.size("tensor")))
            out = out + lora_delta(ab, y, rng)
        if split and name in mesh_mod.ROW_PARALLEL:
            out = mesh_mod.from_tensor(out, mesh)
        bias_key = _BIAS_KEYS.get(name)
        if bias_key in lw:
            out = out + lw[bias_key].to(dtype)
        return out

    return proj


def check_tensor_widths(spec: ModelSpec, tensor: int) -> None:
    """Raise, naming the width, when the tensor axis does not divide the
    heads, the KV heads, the ffn or the vocabulary."""
    for what, width in (("n_heads", spec.n_heads), ("n_kv_heads", spec.n_kv_heads),
                        ("d_ff", spec.d_ff), ("vocab_size", spec.vocab_size)):
        if width % tensor:
            raise ValueError(f"{spec.name}: {what}={width} does not split over the {tensor} "
                             "ranks of the 'tensor' axis")


def apply_model(
    params: Params,
    tokens: torch.Tensor,  # int [B, S]
    spec: ModelSpec,
    lora: Optional[Params] = None,
    lora_spec=None,
    use_pallas: bool = False,
    remat: bool = False,
    return_hidden: bool = False,
    return_kv: bool = False,
    fused_mlp: bool = False,
    ring_mesh=None,
    ring_axis: str = "seq",
    lora_rng: Optional[DropoutKey] = None,
    seg_starts: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Forward pass → logits f32 [B, S, V], or with ``return_hidden=True``
    the final-norm hidden states [B, S, D] in ``spec.dtype`` (callers that
    need a few positions project them themselves). ``return_kv=True``
    returns (hidden [B, S, D], k [L, B, S, KVH, dh], v [L, B, S, KVH, dh]):
    the post-RoPE keys and values of every layer, the prefill of KV-cached
    decode (tst_torch.models.decode).

    ``seg_starts``: int [B, n <= 8] packed-row segment starts (ascending,
    unused slots >= SEG_PAD; tst_torch.data.packing). Attention stays inside
    each token's segment and RoPE positions restart at each start, so a
    packed row is numerically a batch of independent samples.

    ``lora``: an adapter tree (tst_torch.models.lora) added to its
    projections before their biases. A fold-stacked tree (``[k, L, ...]``
    leaves) takes fold-major tokens ``[k·B, S]``: row block f goes through
    fold f's adapter, the base weights once for all rows.

    ``lora_rng``: a :class:`~tst_torch.models.lora.DropoutKey` (the fold of
    each row block, the optimizer step) turns on the adapters' train-time
    dropout when ``lora_spec.dropout > 0``. Each projection of each layer
    draws its own mask from (fold, step, layer, projection), so a
    recomputing backward (``remat``) draws the same masks. Ignored at
    dropout 0, as in the reference.

    ``mesh`` (tst_torch.runtime.mesh): ``params`` and ``lora`` are this
    rank's shards (``shard_tree``, ``local_lora``); the projections follow
    :func:`make_proj`, the embedding and the head split the vocabulary over
    ``tensor``, and the result is whole (every rank gets the same logits).
    ``ring_mesh`` with ``ring_axis`` of size n > 1: the sequence is split
    into n blocks, this rank runs its block through every layer, attention
    goes around the ring (tst_torch.kernels.ring_attention; each block
    through K1 when ``use_pallas``), and the final hidden states are
    gathered; packed rows and the ring exclude each
    other, as in the reference."""
    drop = (lora_rng if lora_rng is not None and lora_spec is not None
            and lora_spec.dropout > 0.0 else None)
    n_folds = fold_count(lora)
    if n_folds is not None and tokens.shape[0] % n_folds:
        raise ValueError(f"{tokens.shape[0]} rows do not split into {n_folds} fold blocks "
                         "for a fold-stacked adapter")
    ring = ring_mesh is not None and ring_mesh.size(ring_axis) > 1
    if ring and seg_starts is not None:
        raise ValueError("packed sequences (seg_starts) and ring attention are mutually "
                         "exclusive: packing is for short rows, the ring for long ones")
    if ring and return_kv:
        raise ValueError("the ring gives no KV cache: decode runs without the seq axis")
    if mesh is None and ring:
        mesh = ring_mesh
    check_remat(remat)
    b, s_full = tokens.shape
    s, pos0 = s_full, 0
    if ring:
        n = ring_mesh.size(ring_axis)
        if s_full % n:
            raise ValueError(f"sequence length {s_full} does not split over the {n} ranks of "
                             f"the {ring_axis!r} axis")
        s = s_full // n
        pos0 = ring_mesh.index(ring_axis) * s
        tokens = tokens[:, pos0: pos0 + s]
        if drop is not None:  # this rank's positions of the dropout masks
            drop = dataclasses.replace(drop, seq=(pos0, s_full))
    dt = spec.dtype
    x = embed_lookup(params, tokens, spec, mesh=mesh)  # [B, S, D]
    cos, sin = rope_tables(s_full, spec.d_head, spec.rope_theta, spec.rope_scaling,
                           device=x.device)
    cos, sin = cos[pos0: pos0 + s], sin[pos0: pos0 + s]
    if seg_starts is not None:
        seg_starts = torch.as_tensor(seg_starts, dtype=torch.int32, device=x.device)
        # per-segment positions: RoPE sees each sample from offset 0
        positions = (torch.arange(s, device=x.device)[None, :]
                     - segment_starts_per_pos(seg_starts, s).long())  # [B, S]
        cos, sin = cos[positions], sin[positions]  # [B, S, dh/2]
    # the dense path's mask; the kernels take the starts themselves
    if use_pallas or ring:
        causal = None
    elif seg_starts is not None:
        causal = segment_mask(seg_starts, s)  # [B, S, S]
    else:
        causal = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
    layers = params["layers"]
    ks, vs = [], []

    def layer_stages(i, lw, la):
        """Layer ``i``'s stages over its weights ``lw`` and adapters ``la``,
        bound here: a checkpointed stage runs again in the backward."""
        proj = make_proj(lw, la, i, lora_spec, dt, mesh=mesh, drop=drop)

        def attn_in(x_in):
            h = mesh_mod.to_tensor(rms_norm(x_in, lw["attn_norm"], spec.rms_eps), mesh)
            q = proj("q", h).reshape(b, s, -1, spec.d_head)
            k = proj("k", h).reshape(b, s, -1, spec.d_head)
            v = proj("v", h).reshape(b, s, -1, spec.d_head)
            return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v

        def attend(q, k, v):
            if ring:
                from tst_torch.kernels.ring_attention import ring_attention

                attn = ring_attention(q, k, v, ring_mesh, seq_axis=ring_axis, causal=True,
                                      use_pallas=bool(use_pallas))
            elif use_pallas:
                attn = _flash_attention(q, k, v, seg_starts)
            else:
                attn = _dense_attention(q, k, v, causal)
            return attn.reshape(b, s, -1)

        def swiglu(h):
            act = F.silu(proj("gate", h).float()).to(dt) * proj("up", h)
            return proj("down", act)

        def rest(x_in, attn):
            h_mid = x_in + proj("o", attn)
            h = mesh_mod.to_tensor(rms_norm(h_mid, lw["mlp_norm"], spec.rms_eps), mesh)
            # the fused kernel only when no adapter targets the MLP (an adapter
            # on gate/up changes the hidden nonlinearly), the reference's condition
            mlp_lora = any(t in la for t in ("gate", "up", "down"))
            if use_pallas is True and fused_mlp and not mlp_lora:
                w = {key: mesh_mod.own_rows(dequantize_leaf(mesh_mod.gather_data(
                    lw[key], mesh_mod.leaf_pspec(f"layers.{key}", lw[key]), mesh), dt), lw[key])
                    for key in ("w_gate", "w_up", "w_down")}
                down = mesh_mod.from_tensor(
                    fused_swiglu_mlp(h, w["w_gate"], w["w_up"], w["w_down"]), mesh)
            elif remat == "light":
                down = _ckpt(swiglu, h)
            else:
                down = swiglu(h)
            return h_mid + down

        return attn_in, attend, rest, use_pallas

    for i in range(spec.n_layers):
        stages = layer_stages(i, {key: layer_of(w, i) for key, w in layers.items()},
                              layer_slice(lora, i) if lora else {})
        if remat:
            x, k, v = _remat_layer(remat, stages, x)
        else:
            x, k, v = _plain_layer(stages, x)
        if return_kv:
            ks.append(k)
            vs.append(v)

    x = rms_norm(x, params["final_norm"], spec.rms_eps)
    if ring:
        x = mesh_mod.gather_seq(x, ring_mesh)
    if return_kv:
        return x, torch.stack(ks), torch.stack(vs)
    if return_hidden:
        return x
    return head_logits(x, params, spec, mesh=mesh)


def head_logits(h: torch.Tensor, params: Params, spec: ModelSpec, mesh=None) -> torch.Tensor:
    """f32 logits [..., V] of hidden rows h [..., D]: bf16 operands, f32
    products and sums (the reference's f32-out einsum). Under ``tensor``
    each rank projects onto its vocabulary slice and the logits are
    gathered; under ``data`` the head is an FSDP shard, gathered for the
    product."""
    key = "embed" if spec.tie_embeddings else "lm_head"
    leaf = params[key]

    def product(y, w):
        return y.float() @ _head_of(w, spec).float()

    if not mesh_mod.active(mesh):
        return product(h, leaf)
    local = mesh_mod.fsdp_apply(product, mesh_mod.to_tensor(h, mesh), leaf,
                                mesh_mod.leaf_pspec(key, leaf), mesh)
    return mesh_mod.gather_tensor(local, mesh)


def layer_of(w, i: int):
    """Layer ``i`` of a stacked leaf, plain or quantized ({"q", "scale"}, and
    a row-parallel shard's ``rows``, tst_torch.runtime.mesh)."""
    if is_quantized_leaf(w):
        return {key: t[i] for key, t in w.items()}
    return w[i]


def embed_lookup(params: Params, tokens: torch.Tensor, spec: ModelSpec,
                 mesh=None) -> torch.Tensor:
    """Token embedding gather in ``spec.dtype``; int8 rows are gathered
    first and only the gathered rows dequantized (f32 product, then cast).
    Under ``tensor`` each rank holds a vocabulary slice: it looks up the
    tokens in its slice, zeros elsewhere, and the ranks' rows are summed
    (exact: one term is not zero); under ``data`` the embedding's columns
    are gathered first."""
    embed = params["embed"]
    if not mesh_mod.active(mesh):
        return _lookup(embed, tokens.long(), spec)
    embed = mesh_mod.gather_data(embed, mesh_mod.leaf_pspec("embed", embed), mesh)
    if mesh.size("tensor") == 1:
        return _lookup(embed, tokens.long(), spec)
    rows = (embed["q"] if is_quantized_leaf(embed) else embed).shape[0]
    ids = tokens.long() - mesh.index("tensor") * rows
    inside = (ids >= 0) & (ids < rows)
    x = _lookup(embed, ids.clamp(0, rows - 1), spec) * inside[..., None].to(spec.dtype)
    return mesh_mod.from_tensor(x, mesh)


def _lookup(embed, ids: torch.Tensor, spec: ModelSpec) -> torch.Tensor:
    if is_quantized_leaf(embed):
        return (embed["q"][ids].float() * embed["scale"][0]).to(spec.dtype)
    return F.embedding(ids, embed).to(spec.dtype)


def _head_of(w, spec: ModelSpec) -> torch.Tensor:
    """The [D, V] head of the embedding or lm_head leaf ``w`` in
    ``spec.dtype`` (a quantized leaf dequantized)."""
    if is_quantized_leaf(w):
        w = dequantize_leaf(w, spec.dtype)
    w = w.to(spec.dtype)
    return w.T if spec.tie_embeddings else w


def lm_head_weight(params: Params, spec: ModelSpec) -> torch.Tensor:
    """[D, V] vocabulary projection (embed transpose when tied); a quantized
    leaf is dequantized to ``spec.dtype``."""
    w = params["embed"] if spec.tie_embeddings else params["lm_head"]
    if is_quantized_leaf(w):
        w = dequantize_leaf(w, spec.dtype)
    return w.T if spec.tie_embeddings else w


class Decoder(torch.nn.Module):
    """Thin ``nn.Module`` over :func:`apply_model`: the weights become
    buffers (the slice never trains the base), so ``.to()`` and
    ``state_dict()`` work; :meth:`tree` gives the stacked dict back."""

    def __init__(self, params: Params, spec: ModelSpec):
        super().__init__()
        self.spec = spec
        self.layers = torch.nn.Module()
        for key, t in params["layers"].items():
            self.layers.register_buffer(key, t)
        for key, t in params.items():
            if key != "layers":
                self.register_buffer(key, t)

    def tree(self) -> Params:
        tree: Params = dict(self.named_buffers(recurse=False))
        tree["layers"] = dict(self.layers.named_buffers())
        return tree

    def forward(self, tokens: torch.Tensor, **kw) -> torch.Tensor:
        return apply_model(self.tree(), tokens, self.spec, **kw)
