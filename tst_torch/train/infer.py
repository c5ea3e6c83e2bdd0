"""Held-out MCQ scoring: per-option probabilities from one forward pass
(port of the single-token paths of ``tst/train/infer.py``, unpacked and
packed).

MCQ answers are single tokens by construction (tst.data.tokenize), so one
forward per sample gives every option's probability: gather the hidden row
at ``answer_pos`` and project it onto the option-letter head columns only
(a [b, D] @ [D, C] product; [b, S, V] logits are never built). Held-out
rows are padded to a common [k, M] grid and scored in fixed chunks of
``batch`` rows, so every chunk has the same shape; fold f's rows go through
fold f's adapter when fold-stacked adapters ``lora_k`` are given, so each
sample is scored by the model that never trained on it. Probabilities are a
softmax over each sample's valid letters. The packed scorer packs each
fold's held-out MCQ rows several to a row (tst_torch.data.packing) and reads
every segment's answer slot from one segment-masked forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from tst_torch.data.packing import pack_rows, padding_seg_row
from tst_torch.models.decoder import apply_model, lm_head_weight
from tst_torch.models.lora import LoraSpec
from tst_torch.models.spec import ModelSpec


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


def make_mcq_scorer(
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    batch: int = 32,
):
    """Returns ``score(base, lora_k|None, tokens, answer_pos, option_ids,
    idx_kM)`` → letter logits f32 [k, M, C].

    ``lora_k``: fold-stacked adapters ([k, L, ...] leaves); fold f's rows are
    scored with fold f's adapter. Each fold's held-out rows are padded (with
    row 0) to a multiple of ``batch`` and scored chunk by chunk in a Python
    loop."""

    def forward_logits(base, lora, tokens_bS, pos_b, option_ids):
        h = apply_model(base, tokens_bS, spec, lora=lora, lora_spec=lora_spec,
                        use_pallas=use_pallas, return_hidden=True)  # [b, S, D]
        h_at = h[torch.arange(h.shape[0], device=h.device), pos_b]  # [b, D]
        head_cols = lm_head_weight(base, spec)[:, option_ids]  # [D, C]
        # bf16 operands, f32 products and sums (an f32-out product)
        return h_at.float() @ head_cols.to(h.dtype).float()

    def score(base, lora_k, tokens, answer_pos, option_ids, idx_kM):
        device = tokens.device
        option_ids = torch.as_tensor(option_ids, dtype=torch.long, device=device)
        idx = torch.as_tensor(idx_kM, dtype=torch.long, device=device)
        k, m = idx.shape
        idx = torch.nn.functional.pad(idx, (0, (-m) % batch))
        out = []
        with torch.inference_mode():
            for f in range(k):
                lora = _fold_adapter(lora_k, f)
                chunks = [forward_logits(base, lora, tokens[idx_b],
                                         answer_pos[idx_b].long(), option_ids)
                          for idx_b in idx[f].split(batch)]
                out.append(torch.cat(chunks)[:m])
        return torch.stack(out)  # [k, M, C]

    return score


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
    batch: int = 32,
    pad_to: Optional[int] = None,
    option_seqs: Optional[np.ndarray] = None,
) -> np.ndarray:
    """End-to-end: held-out per-option probabilities [N, C]. Rows whose fold
    id is outside [0, k) are never scored and keep prob 0."""
    if option_seqs is not None and option_seqs.shape[-1] > 1:
        raise NotImplementedError(
            "multi-token option scoring (tokenizers without single-token "
            "option letters) is not ported to tst_torch yet (ROADMAP item 3)")
    idx, valid = heldout_index_grid(fold_id, k, pad_to=pad_to)
    scorer = make_mcq_scorer(spec, lora_spec, use_pallas, batch)
    ll = scorer(base, lora_k, tokens, answer_pos, option_ids, idx)
    return letter_probs(ll.cpu().numpy(), n_options, idx, valid, tokens.shape[0])


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


def packed_scorer_batch(pack_len: int) -> int:
    """Packed rows per chunk: the unpacked scorer's token budget, 32 × 512."""
    return max(1, (32 * 512) // pack_len)


def make_mcq_scorer_packed(
    spec: ModelSpec,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    batch: int = 16,
):
    """Returns ``score(base, lora_k|None, ptokens [k,R,L], ppos [k,R,G],
    psegs [k,R,G], option_ids)`` → letter logits f32 [k, R, G, C].

    One segment-masked forward per packed row (RoPE restarts per segment),
    in chunks of ``batch`` rows, fold f's rows through fold f's adapter; the
    hidden states at every segment's answer slot are projected onto the
    option-letter head columns only."""

    def score(base, lora_k, ptokens, ppos, psegs, option_ids):
        k, r, s = ptokens.shape
        head_cols = lm_head_weight(base, spec)[:, torch.as_tensor(
            option_ids, dtype=torch.long, device=ptokens.device)]  # [D, C]
        out = []
        with torch.inference_mode():
            for f in range(k):
                lora = _fold_adapter(lora_k, f)
                chunks = []
                for c0 in range(0, r, batch):
                    rows = slice(c0, c0 + batch)
                    h = apply_model(base, ptokens[f, rows], spec, lora=lora,
                                    lora_spec=lora_spec, use_pallas=use_pallas,
                                    return_hidden=True, seg_starts=psegs[f, rows])
                    pos = ppos[f, rows].long().clamp(0, s - 1)  # [b, G]
                    h_at = h.gather(1, pos[..., None].expand(-1, -1, h.shape[-1]))
                    # bf16 operands, f32 products and sums (an f32-out product)
                    chunks.append(h_at.float() @ head_cols.to(h.dtype).float())
                out.append(torch.cat(chunks))
        return torch.stack(out)  # [k, R, G, C]

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
) -> np.ndarray:
    """Packed variant of :func:`score_heldout_mcq`: held-out per-option
    probabilities [N, C]; non-MCQ rows and rows whose fold id is outside
    [0, k) keep prob 0. Single-token options only. The packed rows are
    built on the host and moved to the weights' device."""
    b = batch or packed_scorer_batch(pack_len)
    ptokens, ppos, psegs, srows = pack_heldout_mcq(tb, fold_id, k, pack_len, b)
    device = base["embed"].device
    scorer = make_mcq_scorer_packed(spec, lora_spec, use_pallas, batch=b)
    ll = scorer(base, lora_k, *(torch.from_numpy(a).to(device) for a in (ptokens, ppos, psegs)),
                tb.option_token_ids)
    kk, r, g, c = ll.shape
    flat = ll.cpu().numpy().reshape(kk, r * g, c)
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
    batch: int = 32,
    option_seqs: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Zero-shot scoring of every sample with the base model (the blind
    baseline leg of the vision-blind gap)."""
    n = tokens.shape[0]
    return score_heldout_mcq(
        base, None, spec, None, tokens, answer_pos, option_ids, n_options,
        np.zeros(n, np.int32), k=1, use_pallas=use_pallas, batch=batch,
        option_seqs=option_seqs,
    )
