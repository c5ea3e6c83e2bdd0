"""KV-cached greedy decoding for numeric and open answers (counterpart of
``tst/models/decode.py``).

  * prefill: one forward over the right-padded prompts (``apply_model`` with
    ``return_kv=True``; flash attention with ``use_pallas``) gives the final
    hidden states and the post-RoPE keys and values of every layer;
  * the cache is one preallocated ``[L, B, S_max, KVH, dh]`` tensor each for
    K and V: prompt slots ``[0, S)``, then the generated tokens at slots
    shared by all rows, ``[S, S + step)``, so each step writes its K/V in
    place at one scalar slot;
  * each step runs the layers on one token per row, attends over the cache
    with a per-row mask (f32 scores, masked to -1e30, f32 softmax, as the
    reference, where this is not a Pallas kernel; with ``use_pallas`` on the
    card the CUDA kernel of tst_torch.kernels.decode_attention), and takes
    the argmax of the f32 logits.

A verify chunk of speculative decode (T = gamma + 1) gives, row for row,
the bits of the greedy steps (T = 1) that reach the same positions (ROADMAP
§3, F1): K3's split plan takes no M, so its rows do not depend on the rows
beside them; the attention kernel sums over a query's visible slots by
their rank, a query at a time, whatever the cache's length and wherever
masked slots sit; and every other product (the base projections that K3
does not take, the LoRA deltas, the head) runs one position of the chunk at
a time (:func:`_by_position`), each call at a greedy step's shape, since
the library picks its GEMM, and with it the order of a row's sums, by M
(on the H100 a bf16 base's projections at M = 32 and 96 differed; PERF.md
§6). The norms and elementwise steps are row by row. The card holds this in
chip_smoke.py's phase 20 (int4 and bf16 targets, gamma 2 and 4, 32 and 27
rows), the CPU in tests/test_torch_spec_exact.py.

Packed-int4 layer weights go through the CUDA dequant-matmul K3
(tst_torch.kernels.quant_matmul) with ``use_pallas``: all seven projections,
since the CUDA kernel has none of the TPU kernel's lane limit (N/2 a
multiple of 128), and the arithmetic is ``qdot``'s. Other leaves take
``qdot``. A fold-stacked adapter takes fold-major rows ``[k·B]``, as the
decoder does, so one decode serves every fold.

The reference's layer-loop knobs (``LAYER_LOOP``, ``layer_loop_for``,
``_UNROLL_MAX_LAYERS``) choose between ``lax.scan`` and an unrolled XLA
program; eager PyTorch runs a Python loop over the layers, so they do not
apply and are not ported. ``layer_loop`` arguments are accepted and ignored.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np
import torch

from tst_torch.kernels.decode_attention import cache_attention, cache_attention_reference
from tst_torch.kernels.quant_matmul import NH_MULTIPLE, int4_matmul_stacked
from tst_torch.models.decoder import (apply_model, embed_lookup, head_logits, layer_of,
                                      lm_head_weight, make_proj, rms_norm, rope_tables)
from tst_torch.models.lora import LoraSpec, apply_lora_delta, layer_slice
from tst_torch.models.quant import is_int4_leaf, qdot
from tst_torch.models.spec import ModelSpec
from tst_torch.runtime.mesh import active, to_tensor

def _by_position(fn, y: torch.Tensor) -> torch.Tensor:
    """``fn`` over a chunk's activations y [B, T, ...] → [B, T, ...], one
    position at a time: each call takes a contiguous [B, 1, ...], a greedy
    step's shape, so the library runs the GEMM it runs for that step."""
    if y.shape[1] == 1:
        return fn(y.contiguous())
    return torch.cat([fn(y[:, t: t + 1].contiguous()) for t in range(y.shape[1])], 1)


def _step_dot(y: torch.Tensor, leaf, dtype: torch.dtype, use_pallas: bool) -> torch.Tensor:
    """One decode-step projection, f32 out: y [B, T, D] @ W [D, F] for one
    layer's leaf. A packed-int4 leaf goes through K3 with ``use_pallas``
    where the kernel takes its width (N/2 a multiple of 64: every int4 leaf
    of the repo's Qwen and Llama specs on one rank), as a stack of one layer
    (a view: the stack is read in place), all B·T rows in one call (K3's rows
    do not depend on M); everything else through ``qdot``, a position at a
    time."""
    if use_pallas and is_int4_leaf(leaf) and leaf["q"].ndim == 2 \
            and leaf["q"].shape[-1] % NH_MULTIPLE == 0:
        b, t = y.shape[0], y.shape[1]
        out = int4_matmul_stacked(y.reshape(b * t, y.shape[-1]), leaf["q"][None],
                                  leaf["scale"][None], 0)
        return out.reshape(b, t, out.shape[-1])
    return _by_position(lambda yt: qdot(yt, leaf, dtype, preferred=torch.float32), y)


def _rope_rows(x: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor) -> torch.Tensor:
    """x [B, T, H, dh] rotated at per-row positions (tables [B, T, dh/2])."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos_t[:, :, None, :].to(x.dtype)
    s = sin_t[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _chunk_step(params, lora, lora_spec, spec: ModelSpec, tokens_bt: torch.Tensor,
                pos_bt: torch.Tensor, write_base: int, valid_mask: torch.Tensor,
                k_cache: torch.Tensor, v_cache: torch.Tensor, layer_loop=None,
                use_pallas: bool = False, head: Optional[torch.Tensor] = None,
                rope=None, mesh=None):
    """T-token decode step with the contiguous-slot cache layout → (greedy
    tokens [B, T], caches): the argmax of :func:`chunk_logits`."""
    logits, k_cache, v_cache = chunk_logits(
        params, lora, lora_spec, spec, tokens_bt, pos_bt, write_base, valid_mask, k_cache,
        v_cache, use_pallas=use_pallas, head=head, rope=rope, mesh=mesh)
    return logits.argmax(-1).to(torch.int32), k_cache, v_cache


def chunk_logits(params, lora, lora_spec, spec: ModelSpec, tokens_bt: torch.Tensor,
                 pos_bt: torch.Tensor, write_base: int, valid_mask: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, use_pallas: bool = False,
                 head: Optional[torch.Tensor] = None, rope=None, mesh=None):
    """The f32 logits [B, T, V] of a T-token step with the contiguous-slot
    cache layout.

    ``tokens_bt`` [B, T]; ``pos_bt`` [B, T] per-row positions (RoPE);
    ``write_base`` the shared cache slot of the chunk's first token: its K/V
    land at ``[write_base, write_base + T)`` in place, for all rows at once.
    ``valid_mask`` [B, S_max] marks the committed slots each row may attend
    to; query t also sees chunk slots ``<= t``. ``head`` (the [D, V] head in
    f32) and ``rope`` (the cos/sin tables over S_max) are computed here when
    None; callers looping over steps pass them once. ``mesh``: the
    weights, adapters and caches are this rank's shards (the projections
    of tst_torch.models.decoder ``make_proj``; the cache holds the rank's KV
    heads under ``tensor``), and the logits are whole; ``head`` is then
    not used.
    Returns (logits, caches), the caches updated in place."""
    dt = spec.dtype
    b, t_chunk = tokens_bt.shape
    s_max = k_cache.shape[2]
    device = tokens_bt.device
    x = embed_lookup(params, tokens_bt, spec, mesh=mesh)  # [B, T, D]
    cos_full, sin_full = rope or rope_tables(s_max, spec.d_head, spec.rope_theta,
                                             spec.rope_scaling, device=device)
    pos = pos_bt.long()
    cos_t, sin_t = cos_full[pos], sin_full[pos]
    ar = torch.arange(s_max, device=device)
    tri = (ar[None, :] >= write_base) & (
        (ar[None, :] - write_base) <= torch.arange(t_chunk, device=device)[:, None])  # [T, S]
    mask = valid_mask[:, None, :] | tri[None]  # [B, T, S]
    layers = params["layers"]
    attend = cache_attention if use_pallas else cache_attention_reference

    def base_dot(y, leaf):
        return _step_dot(y, leaf, dt, use_pallas).to(dt)

    def lora_delta(ab, y, rng):
        return _by_position(lambda yt: apply_lora_delta(ab, yt, lora_spec), y)

    for li in range(k_cache.shape[0]):
        lw = {key: layer_of(w, li) for key, w in layers.items()}
        la = layer_slice(lora, li) if lora else {}
        proj = make_proj(lw, la, li, lora_spec, dt, mesh=mesh, base_dot=base_dot,
                         lora_delta=lora_delta)

        h = to_tensor(rms_norm(x, lw["attn_norm"], spec.rms_eps), mesh)
        q = _rope_rows(proj("q", h).reshape(b, t_chunk, -1, spec.d_head), cos_t, sin_t)
        k_new = _rope_rows(proj("k", h).reshape(b, t_chunk, -1, spec.d_head), cos_t, sin_t)
        v_new = proj("v", h).reshape(b, t_chunk, -1, spec.d_head)
        k_cache[li, :, write_base: write_base + t_chunk] = k_new.to(k_cache.dtype)
        v_cache[li, :, write_base: write_base + t_chunk] = v_new.to(v_cache.dtype)
        attn = attend(q, k_cache[li], v_cache[li], mask)
        h_mid = x + proj("o", attn.reshape(b, t_chunk, -1))
        h = to_tensor(rms_norm(h_mid, lw["mlp_norm"], spec.rms_eps), mesh)
        act = torch.nn.functional.silu(proj("gate", h).float()).to(dt) * proj("up", h)
        x = h_mid + proj("down", act)
    x = rms_norm(x, params["final_norm"], spec.rms_eps)
    if active(mesh):
        return _by_position(lambda xt: head_logits(xt, params, spec, mesh=mesh), x), k_cache, \
            v_cache
    if head is None:
        head = lm_head_weight(params, spec).to(dt).float()
    # bf16 operands, f32 products and sums
    return _by_position(lambda xt: xt.float() @ head, x), k_cache, v_cache


def _decode_step(params, lora, lora_spec, spec, token_b, rope_pos_b, write_slot: int,
                 prompt_len_b, prompt_slots: int, k_cache, v_cache, layer_loop=None,
                 use_pallas: bool = False, head=None, rope=None, mesh=None):
    """One greedy step: the T=1 chunk step with the mask of the
    contiguous-slot layout, prompt slots ``[0, prompt_len)`` plus generated
    slots ``[prompt_slots, write_slot)`` (the chunk triangle adds the
    token's own slot). Returns (next token [B], caches)."""
    s_max = k_cache.shape[2]
    ar = torch.arange(s_max, device=token_b.device)[None, :]
    valid = (ar < prompt_len_b[:, None]) | ((ar >= prompt_slots) & (ar < write_slot))
    nxt, k_cache, v_cache = _chunk_step(
        params, lora, lora_spec, spec, token_b[:, None], rope_pos_b[:, None], write_slot,
        valid, k_cache, v_cache, use_pallas=use_pallas, head=head, rope=rope, mesh=mesh)
    return nxt[:, 0], k_cache, v_cache


def prefill(params, tokens: torch.Tensor, prompt_len: torch.Tensor, max_new: int,
            spec: ModelSpec, lora=None, lora_spec: Optional[LoraSpec] = None,
            use_pallas: bool = False, pad_to: Optional[int] = None, mesh=None):
    """One forward over the right-padded prompts → (first greedy token [B],
    k_cache, v_cache [L, B, S_max, KVH, dh], head [D, V] f32, RoPE tables
    over S_max). The caches hold the prompt slots ``[0, S)``; S_max leaves
    room for ``max_new`` generated tokens, padded to a multiple of 128 as in
    the reference. The head (a quantized one dequantized) and the tables are
    made once per call, not once per step. ``mesh``: the weights are this
    rank's shards, the caches hold its KV heads, and the head is None (each
    step projects through the split head)."""
    b, s = tokens.shape
    gen_pad = max_new + (-max_new) % 128
    s_max = pad_to or (s + gen_pad)
    if s_max < s + max_new:
        raise ValueError(
            f"pad_to={pad_to} < prompt slots ({s}) + max_new ({max_new}); "
            "the KV cache needs room for every generated token")
    h, k_all, v_all = apply_model(params, tokens, spec, lora=lora, lora_spec=lora_spec,
                                  use_pallas=use_pallas, return_kv=True, mesh=mesh)
    shape = (k_all.shape[0], b, s_max) + tuple(k_all.shape[3:])
    k_cache = torch.zeros(shape, dtype=k_all.dtype, device=k_all.device)
    v_cache = torch.zeros(shape, dtype=v_all.dtype, device=v_all.device)
    k_cache[:, :, :s] = k_all
    v_cache[:, :, :s] = v_all
    rope = rope_tables(s_max, spec.d_head, spec.rope_theta, spec.rope_scaling,
                       device=tokens.device)
    h_last = h[torch.arange(b, device=h.device), prompt_len.long() - 1]  # [B, D]
    if active(mesh):
        head = None
        token = head_logits(h_last, params, spec, mesh=mesh).argmax(-1).to(torch.int32)
    else:
        head = lm_head_weight(params, spec).to(spec.dtype).float()
        token = (h_last.float() @ head).argmax(-1).to(torch.int32)
    return token, k_cache, v_cache, head, rope


def greedy_decode(
    params,
    tokens: torch.Tensor,  # int [B, S] right-padded prompts
    prompt_len: torch.Tensor,  # int [B]
    max_new: int,
    spec: ModelSpec,
    lora=None,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    pad_to: Optional[int] = None,
    layer_loop: Optional[str] = None,
    mesh=None,
) -> torch.Tensor:
    """Greedy continuation of each prompt → int32 [B, max_new].

    The cache holds the prompt slots ``[0, S)`` and the generated tokens at
    the shared slots ``[S, S + step)`` (:func:`prefill`). A fold-stacked
    ``lora`` takes fold-major rows. The step after the last kept token is
    never run (the reference computes and discards it), so ``max_new - 1``
    steps follow the prefill. ``mesh``: the weights are this rank's shards
    (tensor and FSDP, as in training); every rank of a row set gets the
    same tokens."""
    s = tokens.shape[1]
    prompt_len = prompt_len.to(tokens.device).long()
    with torch.inference_mode():
        token, k_cache, v_cache, head, rope = prefill(
            params, tokens, prompt_len, max_new, spec, lora=lora, lora_spec=lora_spec,
            use_pallas=use_pallas, pad_to=pad_to, mesh=mesh)
        out = [token]
        for t in range(max_new - 1):
            token, k_cache, v_cache = _decode_step(
                params, lora, lora_spec, spec, token, rope_pos_b=prompt_len + t,
                write_slot=s + t, prompt_len_b=prompt_len, prompt_slots=s,
                k_cache=k_cache, v_cache=v_cache, use_pallas=use_pallas, head=head,
                rope=rope, mesh=mesh)
            out.append(token)
    return torch.stack(out, dim=1)  # [B, max_new]


def decode_text(gen_tokens: np.ndarray, tokenizer) -> list:
    """Continuations to text, cut at the first EOS token (the byte tokenizer
    drops ids >= 256, so text generated after EOS would otherwise leak in)."""
    eos = getattr(tokenizer, "eos_id", None)
    out = []
    for ids in np.asarray(gen_tokens):
        ids = [int(t) for t in ids]
        if eos is not None and eos in ids:
            ids = ids[: ids.index(eos)]
        out.append(tokenizer.decode(ids).strip())
    return out


def decode_numeric(texts_tokens: np.ndarray, tokenizer) -> np.ndarray:
    """Greedy continuations parsed into floats (NaN where none parses)."""
    out = np.full(texts_tokens.shape[0], np.nan, np.float32)
    for i, ids in enumerate(texts_tokens):
        text = tokenizer.decode([int(t) for t in ids])
        m = re.search(r"-?\d+(?:\.\d+)?", text.replace(",", ""))
        if m:
            try:
                out[i] = float(m.group())
            except ValueError:
                pass
    return out
