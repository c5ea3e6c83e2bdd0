"""Held-out MCQ scoring: per-option probabilities from one forward pass
(port of the single-token path of ``tst/train/infer.py``).

MCQ answers are single tokens by construction (tst.data.tokenize), so one
forward per sample gives every option's probability: gather the hidden row
at ``answer_pos`` and project it onto the option-letter head columns only
(a [b, D] @ [D, C] product; [b, S, V] logits are never built). Held-out
rows are padded to a common [k, M] grid and scored in fixed chunks of
``batch`` rows, so every chunk has the same shape; fold f's rows go through
fold f's adapter when fold-stacked adapters ``lora_k`` are given, so each
sample is scored by the model that never trained on it. Probabilities are a
softmax over each sample's valid letters.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

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
                lora = None if lora_k is None else {
                    p: {n: t[f] for n, t in ab.items()} for p, ab in lora_k.items()}
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
