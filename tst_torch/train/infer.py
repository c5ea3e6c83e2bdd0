"""Held-out scoring (port of ``tst/train/infer.py``): MCQ rows by
per-option probabilities from one forward pass, unpacked and packed;
numeric and open rows by greedy decode (tst_torch.models.decode).

MCQ answers are single tokens by construction (tst.data.tokenize), so one
forward per sample gives every option's probability: gather the hidden row
at ``answer_pos`` and project it onto the option-letter head columns only
(a [b, D] @ [D, C] product; [b, S, V] logits are never built). Held-out
rows are padded to a common [k, M] grid and scored in fixed chunks of
``batch`` rows, so every chunk has the same shape; fold f's rows go through
fold f's adapter when fold-stacked adapters ``lora_k`` are given, so each
sample is scored by the model that never trained on it. Probabilities are a
softmax over each sample's valid letters. A tokenizer whose option letters
are not single tokens takes the multi-token scorer instead: each option's
token log-probs summed, teacher-forced, one forward an option. The packed
scorer packs each fold's held-out MCQ rows several to a row
(tst_torch.data.packing) and reads every segment's answer slot from one
segment-masked forward.

Numeric and open rows are greedy-decoded with each row's held-out fold
model: the rows of all folds go through one decode per chunk, fold-major
``[k·chunk]``, with the fold-stacked adapters (the reference vmaps the fold
axis instead); numeric answers are scored by per-sample MRA, open ones by
normalized exact match. With a draft model (``perf.spec_draft_*``) the
decode is exact speculative decoding (tst_torch.models.spec_decode): the
same tokens, the draft base-weighted and shared by every fold.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from tst_torch.aux.profile import span
from tst_torch.data.packing import pack_rows, padding_seg_row
from tst_torch.eval.metrics import MRA_THRESHOLDS, open_exact_match
from tst_torch.models.decode import decode_numeric, decode_text, greedy_decode
from tst_torch.models.decoder import apply_model, head_logits, lm_head_weight
from tst_torch.models.lora import LoraSpec, fold_count
from tst_torch.models.quant import quantized_bytes
from tst_torch.models.spec import ModelSpec
from tst_torch.models.spec_decode import speculative_greedy_decode
from tst_torch.runtime import mesh as mesh_mod


def heldout_index_grid(fold_id: np.ndarray, k: int,
                       pad_to: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pad each fold's held-out rows to [k, M] (+ validity mask [k, M]).

    ``pad_to`` pins M (must be >= every fold's held-out count)."""
    rows = [np.flatnonzero(fold_id == f) for f in range(k)]
    m = pad_to or max(len(r) for r in rows)
    if max(len(r) for r in rows) > m:
        raise ValueError(f"pad_to={m} smaller than a fold's held-out count")
    idx = np.zeros((k, m), np.int32)
    valid = np.zeros((k, m), bool)
    for f, r in enumerate(rows):
        idx[f, : len(r)] = r
        valid[f, : len(r)] = True
    return idx, valid


def _fold_adapter(lora_k, f: int):
    """Fold f's adapter from fold-stacked adapters (None stays None)."""
    if lora_k is None:
        return None
    return {p: {n: t[f] for n, t in ab.items()} for p, ab in lora_k.items()}


def _scored_folds(lora_k, k: int, mesh) -> range:
    """The folds this rank scores: its block of the ``fold`` axis when it
    holds only those folds' adapters (a trainer's), else all k (the ranks of
    the fold axis are then replicas)."""
    n = fold_count(lora_k) if lora_k else None
    if mesh_mod.active(mesh) and n is not None and n < k:
        return mesh_mod.fold_range(k, mesh)
    return range(k)


def _data_share(rows: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's share of a chunk's rows over ``data`` (the chunk is a
    multiple of the axis)."""
    if mesh is None or mesh.size("data") == 1:
        return rows
    per = rows.shape[0] // mesh.size("data")
    return rows[mesh.index("data") * per: (mesh.index("data") + 1) * per]


def _to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` as a long tensor on ``device``; from host memory that is a
    pageable copy, which waits for the card's queue."""
    t = torch.as_tensor(a, dtype=torch.long)
    with span("score.rows.to_device", kind="wait", bytes=t.numel() * t.element_size()):
        return t.to(device)


def _chunked_fold_scorer(per_batch, batch: int, mesh=None):
    """The fold and chunk loop the MCQ scorers share: ``score(base,
    lora_k|None, tokens, answer_pos, opt, idx_kM)`` → f32 [k, M, C], each
    fold's held-out rows padded (with row 0) to a multiple of ``batch`` and
    scored chunk by chunk through ``per_batch(base, lora, tokens_bS, pos_b,
    opt)`` → [b, C] with fold f's adapter (``lora_k``: fold-stacked, [k, L,
    ...] leaves). Under ``mesh`` a rank scores its folds (when it holds only
    theirs) and its share of every chunk's rows over ``data``: a chunk is
    ``batch`` rows a rank; the results are gathered, so every rank returns
    the whole [k, M, C]."""

    def score(base, lora_k, tokens, answer_pos, opt, idx_kM):
        device = tokens.device
        with span("score.rows"):
            opt, idx = (_to_device(a, device) for a in (opt, idx_kM))
        k, m = idx.shape
        per = batch * (mesh.size("data") if mesh is not None else 1)
        idx = torch.nn.functional.pad(idx, (0, (-m) % per))
        folds = _scored_folds(lora_k, k, mesh)
        out = []
        with torch.inference_mode():
            for f in folds:
                lora = _fold_adapter(lora_k, f - folds.start if len(folds) < k else f)
                chunks = []
                for idx_c in idx[f].split(per):
                    idx_b = _data_share(idx_c, mesh)
                    with span("score.chunk", fold=f, rows=idx_b.shape[0]):
                        chunks.append(mesh_mod.gather_leaf(
                            per_batch(base, lora, tokens[idx_b], answer_pos[idx_b].long(), opt),
                            ("data",), mesh))
                out.append(torch.cat(chunks)[:m])
        got = torch.stack(out)  # [folds, M, C]
        return mesh_mod.gather_folds(got, mesh) if len(folds) < k else got

    return score


def _letter_logits(h_at: torch.Tensor, base, spec: ModelSpec, option_ids, mesh):
    """f32 logits of the option letters at hidden rows h_at [..., D]: bf16
    operands, f32 products and sums (an f32-out product) on the head's
    letter columns only; under a mesh whose head is split, the whole
    vocabulary's logits (tst_torch.models.decoder.head_logits), then the
    letters'."""
    if mesh_mod.active(mesh):
        return head_logits(h_at, base, spec, mesh=mesh)[..., option_ids]
    head_cols = lm_head_weight(base, spec)[:, option_ids]  # [D, C]
    return h_at.float() @ head_cols.to(h_at.dtype).float()


def make_mcq_scorer(
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    batch: int = 32,
    mesh=None,
):
    """Returns ``score(base, lora_k|None, tokens, answer_pos, option_ids,
    idx_kM)`` → letter logits f32 [k, M, C], in chunks of ``batch`` rows,
    fold f's rows through fold f's adapter (``mesh``: this rank's shards,
    :func:`_chunked_fold_scorer`)."""

    def forward_logits(base, lora, tokens_bS, pos_b, option_ids):
        h = apply_model(base, tokens_bS, spec, lora=lora, lora_spec=lora_spec,
                        use_pallas=use_pallas, return_hidden=True, mesh=mesh)  # [b, S, D]
        h_at = h[torch.arange(h.shape[0], device=h.device), pos_b]  # [b, D]
        return _letter_logits(h_at, base, spec, option_ids, mesh)

    return _chunked_fold_scorer(forward_logits, batch, mesh)


def make_mcq_scorer_multitoken(
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    batch: int = 8,
    mesh=None,
):
    """The multi-token fallback for tokenizers whose option letters are not
    single tokens: each option scores the SUM of its tokens' log-probs,
    teacher-forced after the answer marker (one forward per option and
    chunk of ``batch`` rows). An option whose real tokens run past the
    padded sequence cannot be scored and gets -1e30 (the gold target always
    fits by tokenize's construction).

    Returns ``score(base, lora_k|None, tokens, answer_pos, opt_seqs [C, T]
    (-1 padded), idx_kM)`` → summed option log-probs f32 [k, M, C], as
    :func:`make_mcq_scorer`."""

    def option_logprobs(base, lora, tokens_bS, pos_b, opt_seqs):
        b, s = tokens_bS.shape
        t = opt_seqs.shape[1]
        j_idx = torch.arange(s, device=tokens_bS.device)[None, :] - (pos_b[:, None] + 1)
        in_window = (j_idx >= 0) & (j_idx < t)  # [b, S]: option-token slots
        j_safe = j_idx.clamp(0, t - 1)
        # predictor positions: the hidden state at pos + j predicts token j
        gather_pos = pos_b[:, None] + torch.arange(t, device=tokens_bS.device)[None, :]
        head = (None if mesh_mod.active(mesh)
                else lm_head_weight(base, spec).to(spec.dtype).float())  # [D, V]
        out = []
        for opt_c in opt_seqs:  # [T]
            opt_at = opt_c[j_safe]  # [b, S]
            toks = torch.where(in_window & (opt_at >= 0), opt_at, tokens_bS)
            h = apply_model(base, toks, spec, lora=lora, lora_spec=lora_spec,
                            use_pallas=use_pallas, return_hidden=True, mesh=mesh)  # [b, S, D]
            fits = ((opt_c[None, :] < 0) | (gather_pos <= s - 1)).all(1)  # [b]
            h_at = h.gather(1, gather_pos.clamp(0, s - 1)[..., None].expand(-1, -1, h.shape[-1]))
            # bf16 operands, f32 products and sums (an f32-out product)
            logits = (head_logits(h_at, base, spec, mesh=mesh) if head is None
                      else h_at.float() @ head)
            logp = torch.log_softmax(logits, dim=-1)  # [b, T, V]
            tok_lp = logp.gather(2, opt_c.clamp_min(0)[None, :, None].expand(b, t, 1))[..., 0]
            summed = torch.where(opt_c[None, :] >= 0, tok_lp, 0.0).sum(-1)
            out.append(torch.where(fits, summed, -1e30))
        return torch.stack(out, dim=1)  # [b, C]

    return _chunked_fold_scorer(option_logprobs, batch, mesh)


def _to_host(ll: torch.Tensor) -> np.ndarray:
    """The letter logits on the host: the copy waits for the card."""
    with span("score.to_host", kind="wait", bytes=ll.numel() * ll.element_size()):
        return ll.cpu().numpy()


#: the scoring calls of this process, each a unit of the scorer's spans
_CALLS = itertools.count()


def letter_probs(
    letter_logits: np.ndarray,  # [k, M, C]
    n_options: np.ndarray,  # [N]
    idx: np.ndarray,  # [k, M]
    valid: np.ndarray,  # [k, M]
    n: int,
) -> np.ndarray:
    """Scatter per-fold letter logits back to [N, C] option probabilities,
    softmaxed over each sample's valid options."""
    k, m, c = letter_logits.shape
    probs = np.zeros((n, c), np.float32)
    ll = np.asarray(letter_logits, np.float32)
    for f in range(k):
        rows = idx[f][valid[f]]
        x = ll[f][valid[f]]  # [r, C]
        nopt = n_options[rows]  # [r]
        mask = np.arange(c)[None, :] < nopt[:, None]
        x = np.where(mask, x, -np.inf)
        # non-MCQ rows (nopt == 0) have no valid options: leave probs at 0
        finite = nopt > 0
        x = x - np.where(finite, x.max(-1, where=mask, initial=-1e30), 0.0)[:, None]
        e = np.where(mask, np.exp(x), 0.0)
        denom = e.sum(-1, keepdims=True)
        probs[rows] = np.where(finite[:, None], e / np.maximum(denom, 1e-30), 0.0)
    return probs


def score_heldout_mcq(
    base,
    lora_k,
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec],
    tokens: torch.Tensor,
    answer_pos: torch.Tensor,
    option_ids: np.ndarray,
    n_options: np.ndarray,
    fold_id: np.ndarray,
    k: int,
    use_pallas: bool = False,
    batch: Optional[int] = None,
    pad_to: Optional[int] = None,
    option_seqs: Optional[np.ndarray] = None,
    mesh=None,
) -> np.ndarray:
    """End-to-end: held-out per-option probabilities [N, C]. Rows whose fold
    id is outside [0, k) are never scored and keep prob 0. ``option_seqs``
    ([C, T], -1 padded, T > 1) takes the multi-token scorer, in chunks of
    at most 8 rows. ``batch``: rows a chunk, by default
    :func:`scorer_batch` of the row length. ``mesh``: this rank's shards;
    every rank gets the whole result."""
    with span("score.call", unit=next(_CALLS)):
        batch = batch or scorer_batch(tokens.shape[1])
        idx, valid = heldout_index_grid(fold_id, k, pad_to=pad_to)
        if option_seqs is not None and option_seqs.shape[-1] > 1:
            scorer = make_mcq_scorer_multitoken(spec, lora_spec, use_pallas,
                                                batch=min(batch, 8), mesh=mesh)
            ll = scorer(base, lora_k, tokens, answer_pos, option_seqs, idx)
        else:
            scorer = make_mcq_scorer(spec, lora_spec, use_pallas, batch, mesh=mesh)
            ll = scorer(base, lora_k, tokens, answer_pos, option_ids, idx)
        ll = _to_host(ll)
        with span("score.probs"):
            return letter_probs(ll, n_options, idx, valid, tokens.shape[0])


def pack_heldout_mcq(tb, fold_id: np.ndarray, k: int, pack_len: int, batch: int,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pack each fold's held-out MCQ rows for the packed scorer (the
    trainer's first-fit packer) → (ptokens [k,R,L], ppos [k,R,G], psegs
    [k,R,G], sample_rows [k,R,G]). R is padded to a multiple of ``batch``;
    padding rows hold pad tokens, answer slots -1 and one segment at 0."""
    is_mcq = tb.gold >= 0
    packs = [pack_rows(tb, np.flatnonzero((fold_id == f) & is_mcq), pack_len)
             for f in range(k)]
    r = max(max(p.n_rows for p in packs), 1)
    r += (-r) % batch

    def pad_rows(a, fill):
        out = np.full((r,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    ptokens = np.stack([pad_rows(p.tokens, tb.pad_id) for p in packs])
    ppos = np.stack([pad_rows(p.answer_pos, -1) for p in packs])
    psegs = np.stack([pad_rows(p.seg_starts, padding_seg_row()) for p in packs])
    srows = np.stack([pad_rows(p.sample_rows, -1) for p in packs])
    return ptokens, ppos, psegs, srows


#: the scorers' tokens a chunk: 32 rows of 512
SCORER_TOKENS = 32 * 512


def packed_scorer_batch(pack_len: int) -> int:
    """Packed rows per chunk: the unpacked scorer's token budget, 32 × 512."""
    return max(1, SCORER_TOKENS // pack_len)


def scorer_batch(seq_len: int, batch: int = 32) -> int:
    """Rows a chunk of the unpacked scorer: ``batch`` (the reference's 32)
    up to 512 tokens a row, and the same token budget for longer rows (one
    row a chunk at 16384). The reference pads every fold's rows to chunks
    of 32 whatever their length; rows are scored independently, so a
    smaller chunk changes no row's number, and at 16384 tokens it keeps a
    fold of 2 held-out rows from running 30 rows of padding."""
    return max(1, min(batch, SCORER_TOKENS // max(seq_len, 1)))


def make_mcq_scorer_packed(
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    batch: int = 16,
    mesh=None,
):
    """Returns ``score(base, lora_k|None, ptokens [k,R,L], ppos [k,R,G],
    psegs [k,R,G], option_ids)`` → letter logits f32 [k, R, G, C].

    One segment-masked forward per packed row (RoPE restarts per segment),
    in chunks of ``batch`` rows, fold f's rows through fold f's adapter; the
    hidden states at every segment's answer slot are projected onto the
    option-letter head columns only. Under ``mesh`` the folds and each
    chunk's rows split as in :func:`_chunked_fold_scorer` (R a multiple of
    ``batch`` times the data axis)."""

    def score(base, lora_k, ptokens, ppos, psegs, option_ids):
        k, r, s = ptokens.shape
        with span("score.rows"):
            opt = _to_device(option_ids, ptokens.device)
        per = batch * (mesh.size("data") if mesh is not None else 1)
        folds = _scored_folds(lora_k, k, mesh)
        out = []
        with torch.inference_mode():
            for f in folds:
                lora = _fold_adapter(lora_k, f - folds.start if len(folds) < k else f)
                chunks = []
                for c0 in range(0, r, per):
                    rows = _data_share(torch.arange(c0, min(c0 + per, r),
                                                    device=ptokens.device), mesh)
                    with span("score.chunk", fold=f, rows=rows.shape[0]):
                        h = apply_model(base, ptokens[f, rows], spec, lora=lora,
                                        lora_spec=lora_spec, use_pallas=use_pallas,
                                        return_hidden=True, seg_starts=psegs[f, rows],
                                        mesh=mesh)
                        pos = ppos[f, rows].long().clamp(0, s - 1)  # [b, G]
                        h_at = h.gather(1, pos[..., None].expand(-1, -1, h.shape[-1]))
                        chunks.append(mesh_mod.gather_leaf(
                            _letter_logits(h_at, base, spec, opt, mesh), ("data",), mesh))
                out.append(torch.cat(chunks))
        got = torch.stack(out)  # [folds, R, G, C]
        return mesh_mod.gather_folds(got, mesh) if len(folds) < k else got

    return score


def score_heldout_mcq_packed(
    base,
    lora_k,
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec],
    tb,
    fold_id: np.ndarray,
    k: int,
    pack_len: int,
    use_pallas: bool = False,
    batch: Optional[int] = None,
    mesh=None,
) -> np.ndarray:
    """Packed variant of :func:`score_heldout_mcq`: held-out per-option
    probabilities [N, C]; non-MCQ rows and rows whose fold id is outside
    [0, k) keep prob 0. Single-token options only. The packed rows are
    built on the host and moved to the weights' device."""
    with span("score.call", unit=next(_CALLS)):
        b = batch or packed_scorer_batch(pack_len)
        data = mesh.size("data") if mesh is not None else 1
        ptokens, ppos, psegs, srows = pack_heldout_mcq(tb, fold_id, k, pack_len, b * data)
        device = _device_of(base)
        scorer = make_mcq_scorer_packed(spec, lora_spec, use_pallas, batch=b, mesh=mesh)
        with span("score.rows"), span("score.rows.to_device", kind="wait",
                                      bytes=ptokens.nbytes + ppos.nbytes + psegs.nbytes):
            packed = [torch.from_numpy(a).to(device) for a in (ptokens, ppos, psegs)]
        ll = scorer(base, lora_k, *packed, tb.option_token_ids)
        kk, r, g, c = ll.shape
        flat = _to_host(ll).reshape(kk, r * g, c)
        with span("score.probs"):
            idx = srows.reshape(kk, r * g)
            valid = idx >= 0
            return letter_probs(flat, tb.n_options, np.where(valid, idx, 0), valid, tb.n)


def score_all_mcq(
    base,
    spec: ModelSpec,
    tokens: torch.Tensor,
    answer_pos: torch.Tensor,
    option_ids: np.ndarray,
    n_options: np.ndarray,
    use_pallas: bool = False,
    batch: Optional[int] = None,
    option_seqs: Optional[np.ndarray] = None,
    mesh=None,
) -> np.ndarray:
    """Zero-shot scoring of every sample with the base model (the blind
    baseline leg of the vision-blind gap)."""
    n = tokens.shape[0]
    return score_heldout_mcq(
        base, None, spec, None, tokens, answer_pos, option_ids, n_options,
        np.zeros(n, np.int32), k=1, use_pallas=use_pallas, batch=batch,
        option_seqs=option_seqs, mesh=mesh,
    )


def _device_of(base) -> torch.device:
    embed = base["embed"]
    return (embed["q"] if isinstance(embed, dict) else embed).device


def decode_chunk_rows(spec: ModelSpec, seq_len: int, max_new: int, k: int,
                      base_bytes: Optional[int] = None, draft_spec: Optional[ModelSpec] = None,
                      ) -> int:
    """Rows per fold of one held-out decode chunk: the reference's budget
    (the KV cache, k·rows × [L, S + pad, KVH, dh] × 2 in ``spec.dtype``, in
    what a 16 GB chip has left after the base weights), capped at 32 rows.
    At 0.5B the cap binds. Sizing it for 80 GB is open (ROADMAP §2 P5)."""
    s_max = seq_len + max_new + (-max_new) % 128
    itemsize = torch.empty((), dtype=spec.dtype).element_size()
    row_bytes = spec.n_layers * s_max * spec.n_kv_heads * spec.d_head * 2 * itemsize
    if draft_spec is not None:
        row_bytes += (draft_spec.n_layers * s_max * draft_spec.n_kv_heads * draft_spec.d_head
                      * 2 * torch.empty((), dtype=draft_spec.dtype).element_size())
    budget = 2.5e9 if base_bytes is None else max(1.5e9, 10.5e9 - base_bytes)
    return max(1, min(32, int(budget / max(k * row_bytes, 1))))


def _decode_heldout_rows(
    base, lora_k, spec: ModelSpec, lora_spec: Optional[LoraSpec], tokens: torch.Tensor,
    answer_pos: torch.Tensor, rows: np.ndarray, fold_id: np.ndarray, k: int, max_new: int,
    use_pallas: bool, pad_to: Optional[int] = None, chunk: Optional[int] = None,
    draft=None, gamma: int = 2, mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy-decode ``rows`` with each row's held-out fold model →
    (gen [k, M, max_new], idx [k, M], valid [k, M]).

    Rows are padded (with row 0) to a [k, M] grid and decoded in chunks of
    ``chunk`` rows per fold; a chunk's rows of all folds go through one
    decode as fold-major ``[k·chunk]`` rows with the fold-stacked adapters
    ``lora_k`` (or the base model when None), so each projection runs once
    for every fold. ``draft`` = (draft_spec, draft_params) decodes each
    chunk by exact speculative decoding with ``gamma`` proposals a round:
    the same tokens; the chunk is sized for both models' caches. Under
    ``mesh`` a rank decodes its folds (when it holds only their adapters)
    and its share of each chunk's rows over ``data`` (the chunk rounded up
    to the axis), with its shards (KV heads split over ``tensor``); the
    tokens are gathered, so every rank returns the whole grid."""
    rows_by_fold = [rows[fold_id[rows] == f] for f in range(k)]
    m = pad_to or max(max((len(r) for r in rows_by_fold), default=1), 1)
    if max((len(r) for r in rows_by_fold), default=0) > m:
        raise ValueError(f"pad_to={m} smaller than a fold's held-out count")
    idx = np.zeros((k, m), np.int32)
    valid = np.zeros((k, m), bool)
    for f, r in enumerate(rows_by_fold):
        idx[f, : len(r)] = r
        valid[f, : len(r)] = True
    if chunk is None:
        bb = quantized_bytes(base) + (quantized_bytes(draft[1]) if draft is not None else 0)
        chunk = decode_chunk_rows(spec, tokens.shape[1], max_new, k, base_bytes=bb,
                                  draft_spec=draft[0] if draft is not None else None)
    mc = min(m, max(int(chunk), 1))
    data = mesh.size("data") if mesh is not None else 1
    mc += (-mc) % data
    idx_p = np.pad(idx, ((0, 0), (0, (-m) % mc)))
    folds = _scored_folds(lora_k, k, mesh)
    prompt_len = answer_pos.long() + 1  # decode continues right after the marker
    outs = []
    for c0 in range(0, idx_p.shape[1], mc):
        block = idx_p[folds.start: folds.stop, c0: c0 + mc]
        if data > 1:
            per = mc // data
            block = block[:, mesh.index("data") * per: (mesh.index("data") + 1) * per]
        sel = torch.from_numpy(block.reshape(-1).astype(np.int64)).to(
            tokens.device)  # fold-major [folds·rows]
        if draft is not None:
            gen = speculative_greedy_decode(draft[1], draft[0], base, spec, tokens[sel],
                                            prompt_len[sel], max_new, gamma=gamma, lora=lora_k,
                                            lora_spec=lora_spec, use_pallas=use_pallas,
                                            mesh=mesh)
        else:
            gen = greedy_decode(base, tokens[sel], prompt_len[sel], max_new, spec, lora=lora_k,
                                lora_spec=lora_spec, use_pallas=use_pallas, mesh=mesh)
        gen = gen.reshape(len(folds), block.shape[1], max_new)
        outs.append(mesh_mod.gather_leaf(gen, (None, "data"), mesh))
    gen = torch.cat(outs, dim=1)[:, :m]
    if len(folds) < k:
        gen = mesh_mod.gather_folds(gen, mesh)
    return gen.cpu().numpy(), idx, valid


def score_heldout_numeric(
    base, lora_k, spec: ModelSpec, lora_spec: Optional[LoraSpec], tokens: torch.Tensor,
    answer_pos: torch.Tensor,  # last prompt-token index
    gold_values: np.ndarray,  # [N] float, NaN on non-numeric rows
    fold_id: np.ndarray, k: int, tokenizer=None, max_new: int = 12,
    use_pallas: bool = False, pad_to: Optional[int] = None, draft=None, gamma: int = 2,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy-decode numeric answers with each row's held-out fold model →
    (pred_values [N], per-sample MRA [N]), NaN on other rows. The per-sample
    MRA is the numeric rows' s(x)."""
    n = tokens.shape[0]
    numeric_rows = np.flatnonzero(np.isfinite(gold_values))
    pred = np.full(n, np.nan, np.float32)
    s_num = np.full(n, np.nan, np.float32)
    if len(numeric_rows) == 0:
        return pred, s_num
    gen, idx, valid = _decode_heldout_rows(
        base, lora_k, spec, lora_spec, tokens, answer_pos, numeric_rows, fold_id, k,
        max_new, use_pallas, pad_to=pad_to, draft=draft, gamma=gamma, mesh=mesh)
    for f in range(k):
        rows = idx[f][valid[f]]
        vals = decode_numeric(gen[f][valid[f]], tokenizer)
        pred[rows] = vals
        rel = np.abs(vals - gold_values[rows]) / np.maximum(np.abs(gold_values[rows]), 1e-9)
        rel = np.where(np.isnan(vals), np.inf, rel)
        s_num[rows] = np.mean([(rel < (1.0 - th)).astype(np.float32) for th in MRA_THRESHOLDS],
                              axis=0)
    return pred, s_num


def score_heldout_open(
    base, lora_k, spec: ModelSpec, lora_spec: Optional[LoraSpec], tokens: torch.Tensor,
    answer_pos: torch.Tensor,
    gold_texts: Sequence[Optional[str]],  # [N]; None on non-open rows
    fold_id: np.ndarray, k: int, tokenizer=None, max_new: int = 16,
    use_pallas: bool = False, pad_to: Optional[int] = None, draft=None, gamma: int = 2,
    mesh=None,
) -> Tuple[list, np.ndarray]:
    """Greedy-decode open answers with each row's held-out fold model →
    (pred_texts [N], None on other rows; s_open [N]: 1.0 when the normalized
    answer matches the gold one, NaN on other rows)."""
    n = tokens.shape[0]
    open_rows = np.array([i for i, g in enumerate(gold_texts) if g is not None], np.int32)
    pred_texts: list = [None] * n
    s_open = np.full(n, np.nan, np.float32)
    if len(open_rows) == 0:
        return pred_texts, s_open
    gen, idx, valid = _decode_heldout_rows(
        base, lora_k, spec, lora_spec, tokens, answer_pos, open_rows, fold_id, k, max_new,
        use_pallas, pad_to=pad_to, draft=draft, gamma=gamma, mesh=mesh)
    for f in range(k):
        rows = idx[f][valid[f]]
        for r, t in zip(rows, decode_text(gen[f][valid[f]], tokenizer)):
            pred_texts[r] = t
            s_open[r] = open_exact_match(t, gold_texts[r])
    return pred_texts, s_open
