"""Bias score s(x) assignment (counterpart of ``tst/diagnose/score.py``,
whose module imports jax.numpy; the computation itself is numpy).

Every rule maps held-out per-option probabilities (or several epochs or seeds
of them, averaged) to one number per sample; higher means more
shortcut-exploitable:

  * ``gold_prob``   — probability of the gold answer (the default)
  * ``correct``     — exact-match correctness of the argmax
  * ``margin``      — gold probability minus the best other option's
  * ``excess_prob`` — gold probability minus chance (1/n_options)
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np

SCORE_RULES = ("gold_prob", "correct", "margin", "excess_prob")


def bias_scores(
    probs: Union[np.ndarray, Sequence[np.ndarray]],
    gold: np.ndarray,
    n_options: np.ndarray,
    rule: str = "gold_prob",
) -> np.ndarray:
    """Held-out option probabilities [N, C] (or a sequence of them, averaged)
    → s(x) f32 [N]. Non-MCQ rows (gold < 0) get NaN."""
    if rule not in SCORE_RULES:
        raise ValueError(f"unknown score rule {rule!r}; have {SCORE_RULES}")
    if not isinstance(probs, np.ndarray):
        probs = np.mean([np.asarray(p) for p in probs], axis=0)
    probs = np.asarray(probs, np.float32)
    gold = np.asarray(gold)
    n, c = probs.shape
    if c == 0:  # no MCQ rows (all numeric/open)
        return np.full(n, np.nan, np.float32)
    valid = gold >= 0
    g = np.clip(gold, 0, c - 1)
    gold_p = probs[np.arange(n), g]
    if rule == "gold_prob":
        s = gold_p
    elif rule == "correct":
        s = (probs.argmax(-1) == g).astype(np.float32)
    elif rule == "margin":
        masked = probs.copy()
        masked[np.arange(n), g] = -np.inf
        s = gold_p - masked.max(-1)
    else:  # excess_prob
        s = gold_p - 1.0 / np.maximum(np.asarray(n_options, np.float32), 1.0)
    return np.where(valid, s, np.nan).astype(np.float32)


def rank_by_bias(s: np.ndarray) -> np.ndarray:
    """Indices most-biased first; NaNs (non-MCQ) last; ties by index."""
    s = np.asarray(s, np.float32)
    key = np.where(np.isnan(s), -np.inf, s)
    return np.argsort(-key, kind="stable")
