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
    with a per-row mask (plain torch: f32 scores, masked to -1e30, f32
    softmax, as the reference, where this is not a Pallas kernel either),
    and takes the argmax of the f32 logits.

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

from tst_torch.kernels.quant_matmul import NH_MULTIPLE, int4_matmul_stacked
from tst_torch.models.decoder import (apply_model, embed_lookup, layer_of, lm_head_weight,
                                      rms_norm, rope_tables)
from tst_torch.models.lora import LoraSpec, apply_lora_delta, layer_slice
from tst_torch.models.quant import is_int4_leaf, qdot
from tst_torch.models.spec import ModelSpec

_BIAS_KEYS = {"q": "bq", "k": "bk", "v": "bv"}


def _step_dot(y: torch.Tensor, leaf, dtype: torch.dtype, use_pallas: bool,
              stack=None, li: Optional[int] = None) -> torch.Tensor:
    """One decode-step projection, f32 out: y [B, T, D] @ W [D, F]. A
    packed-int4 layer stack (``stack``, indexed by ``li``) goes through K3
    with ``use_pallas`` where the kernel takes its width (N/2 a multiple of
    64: every int4 leaf of the repo's Qwen and Llama specs); everything else
    through ``qdot`` on the layer's leaf, with the same numbers."""
    if use_pallas and stack is not None and li is not None and is_int4_leaf(stack) \
            and stack["q"].ndim == 3 and stack["q"].shape[-1] % NH_MULTIPLE == 0:
        b, t = y.shape[0], y.shape[1]
        out = int4_matmul_stacked(y.reshape(b * t, y.shape[-1]), stack["q"], stack["scale"], li)
        return out.reshape(b, t, out.shape[-1])
    return qdot(y, leaf, dtype, preferred=torch.float32)


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
                rope=None):
    """T-token decode step with the contiguous-slot cache layout → (greedy
    tokens [B, T], caches): the argmax of :func:`chunk_logits`."""
    logits, k_cache, v_cache = chunk_logits(
        params, lora, lora_spec, spec, tokens_bt, pos_bt, write_base, valid_mask, k_cache,
        v_cache, use_pallas=use_pallas, head=head, rope=rope)
    return logits.argmax(-1).to(torch.int32), k_cache, v_cache


def chunk_logits(params, lora, lora_spec, spec: ModelSpec, tokens_bt: torch.Tensor,
                 pos_bt: torch.Tensor, write_base: int, valid_mask: torch.Tensor,
                 k_cache: torch.Tensor, v_cache: torch.Tensor, use_pallas: bool = False,
                 head: Optional[torch.Tensor] = None, rope=None):
    """The f32 logits [B, T, V] of a T-token step with the contiguous-slot
    cache layout.

    ``tokens_bt`` [B, T]; ``pos_bt`` [B, T] per-row positions (RoPE);
    ``write_base`` the shared cache slot of the chunk's first token: its K/V
    land at ``[write_base, write_base + T)`` in place, for all rows at once.
    ``valid_mask`` [B, S_max] marks the committed slots each row may attend
    to; query t also sees chunk slots ``<= t``. ``head`` (the [D, V] head in
    f32) and ``rope`` (the cos/sin tables over S_max) are computed here when
    None; callers looping over steps pass them once.
    Returns (logits, caches), the caches updated in place."""
    dt = spec.dtype
    b, t_chunk = tokens_bt.shape
    s_max = k_cache.shape[2]
    device = tokens_bt.device
    x = embed_lookup(params, tokens_bt, spec)  # [B, T, D]
    cos_full, sin_full = rope or rope_tables(s_max, spec.d_head, spec.rope_theta,
                                             spec.rope_scaling, device=device)
    pos = pos_bt.long()
    cos_t, sin_t = cos_full[pos], sin_full[pos]
    ar = torch.arange(s_max, device=device)
    tri = (ar[None, :] >= write_base) & (
        (ar[None, :] - write_base) <= torch.arange(t_chunk, device=device)[:, None])  # [T, S]
    mask = valid_mask[:, None, :] | tri[None]  # [B, T, S]
    layers = params["layers"]
    groups = spec.n_heads // spec.n_kv_heads

    for li in range(k_cache.shape[0]):
        lw = {key: layer_of(w, li) for key, w in layers.items()}
        la = layer_slice(lora, li) if lora else {}

        def proj(name, y, w_key):
            out = _step_dot(y, lw[w_key], dt, use_pallas, stack=layers[w_key], li=li).to(dt)
            if name in la:
                out = out + apply_lora_delta(la[name], y, lora_spec)
            bias_key = _BIAS_KEYS.get(name)
            if bias_key in lw:
                out = out + lw[bias_key].to(dt)
            return out

        h = rms_norm(x, lw["attn_norm"], spec.rms_eps)
        q = _rope_rows(proj("q", h, "wq").reshape(b, t_chunk, spec.n_heads, spec.d_head),
                       cos_t, sin_t)
        k_new = _rope_rows(proj("k", h, "wk").reshape(b, t_chunk, spec.n_kv_heads, spec.d_head),
                           cos_t, sin_t)
        v_new = proj("v", h, "wv").reshape(b, t_chunk, spec.n_kv_heads, spec.d_head)
        k_cache[li, :, write_base: write_base + t_chunk] = k_new.to(k_cache.dtype)
        v_cache[li, :, write_base: write_base + t_chunk] = v_new.to(v_cache.dtype)
        kc, vc = k_cache[li], v_cache[li]
        qg = q.reshape(b, t_chunk, spec.n_kv_heads, groups, spec.d_head)
        scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), kc.float()) / np.sqrt(spec.d_head)
        scores = scores.masked_fill(~mask[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(dt)
        attn = torch.einsum("bkgts,bskd->btkgd", probs.float(), vc.float()).to(dt)
        h_mid = x + proj("o", attn.reshape(b, t_chunk, spec.q_dim), "wo")
        h = rms_norm(h_mid, lw["mlp_norm"], spec.rms_eps)
        act = torch.nn.functional.silu(proj("gate", h, "w_gate").float()).to(dt) \
            * proj("up", h, "w_up")
        x = h_mid + proj("down", act, "w_down")
    x = rms_norm(x, params["final_norm"], spec.rms_eps)
    if head is None:
        head = lm_head_weight(params, spec).to(dt).float()
    return x.float() @ head, k_cache, v_cache  # bf16 operands, f32 products and sums


def _decode_step(params, lora, lora_spec, spec, token_b, rope_pos_b, write_slot: int,
                 prompt_len_b, prompt_slots: int, k_cache, v_cache, layer_loop=None,
                 use_pallas: bool = False, head=None, rope=None):
    """One greedy step: the T=1 chunk step with the mask of the
    contiguous-slot layout, prompt slots ``[0, prompt_len)`` plus generated
    slots ``[prompt_slots, write_slot)`` (the chunk triangle adds the
    token's own slot). Returns (next token [B], caches)."""
    s_max = k_cache.shape[2]
    ar = torch.arange(s_max, device=token_b.device)[None, :]
    valid = (ar < prompt_len_b[:, None]) | ((ar >= prompt_slots) & (ar < write_slot))
    nxt, k_cache, v_cache = _chunk_step(
        params, lora, lora_spec, spec, token_b[:, None], rope_pos_b[:, None], write_slot,
        valid, k_cache, v_cache, use_pallas=use_pallas, head=head, rope=rope)
    return nxt[:, 0], k_cache, v_cache


def prefill(params, tokens: torch.Tensor, prompt_len: torch.Tensor, max_new: int,
            spec: ModelSpec, lora=None, lora_spec: Optional[LoraSpec] = None,
            use_pallas: bool = False, pad_to: Optional[int] = None):
    """One forward over the right-padded prompts → (first greedy token [B],
    k_cache, v_cache [L, B, S_max, KVH, dh], head [D, V] f32, RoPE tables
    over S_max). The caches hold the prompt slots ``[0, S)``; S_max leaves
    room for ``max_new`` generated tokens, padded to a multiple of 128 as in
    the reference. The head (a quantized one dequantized) and the tables are
    made once per call, not once per step."""
    b, s = tokens.shape
    gen_pad = max_new + (-max_new) % 128
    s_max = pad_to or (s + gen_pad)
    if s_max < s + max_new:
        raise ValueError(
            f"pad_to={pad_to} < prompt slots ({s}) + max_new ({max_new}); "
            "the KV cache needs room for every generated token")
    h, k_all, v_all = apply_model(params, tokens, spec, lora=lora, lora_spec=lora_spec,
                                  use_pallas=use_pallas, return_kv=True)
    shape = (k_all.shape[0], b, s_max) + tuple(k_all.shape[3:])
    k_cache = torch.zeros(shape, dtype=k_all.dtype, device=k_all.device)
    v_cache = torch.zeros(shape, dtype=v_all.dtype, device=v_all.device)
    k_cache[:, :, :s] = k_all
    v_cache[:, :, :s] = v_all
    head = lm_head_weight(params, spec).to(spec.dtype).float()
    rope = rope_tables(s_max, spec.d_head, spec.rope_theta, spec.rope_scaling,
                       device=tokens.device)
    h_last = h[torch.arange(b, device=h.device), prompt_len.long() - 1]  # [B, D]
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
) -> torch.Tensor:
    """Greedy continuation of each prompt → int32 [B, max_new].

    The cache holds the prompt slots ``[0, S)`` and the generated tokens at
    the shared slots ``[S, S + step)`` (:func:`prefill`). A fold-stacked
    ``lora`` takes fold-major rows. The step after the last kept token is
    never run (the reference computes and discards it), so ``max_new - 1``
    steps follow the prefill."""
    s = tokens.shape[1]
    prompt_len = prompt_len.to(tokens.device).long()
    with torch.inference_mode():
        token, k_cache, v_cache, head, rope = prefill(
            params, tokens, prompt_len, max_new, spec, lora=lora, lora_spec=lora_spec,
            use_pallas=use_pallas, pad_to=pad_to)
        out = [token]
        for t in range(max_new - 1):
            token, k_cache, v_cache = _decode_step(
                params, lora, lora_spec, spec, token, rope_pos_b=prompt_len + t,
                write_slot=s + t, prompt_len_b=prompt_len, prompt_slots=s,
                k_cache=k_cache, v_cache=v_cache, use_pallas=use_pallas, head=head,
                rope=rope)
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
