"""Evaluation metrics for blind stress-testing (port of ``tst/eval/metrics.py``,
which computes with jax.numpy).

Blind accuracy vs chance (the shortcut signal), per-category accuracy, Mean
Relative Accuracy for VSI-Bench numeric answers, the vision-blind gap
report, and open-answer normalization. The array metrics are mask-aware torch functions that take
numpy arrays or tensors and return 0-d f32 tensors.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import numpy as np
import torch

#: MRA confidence thresholds θ ∈ {0.5, 0.55, ..., 0.95}: a prediction scores
#: at θ if |pred - gold| / |gold| < 1 - θ.
MRA_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))


def accuracy(pred, gold, mask=None) -> torch.Tensor:
    """Masked exact-match accuracy. pred/gold int arrays, mask float/bool."""
    pred, gold = torch.as_tensor(pred), torch.as_tensor(gold)
    ok = (pred == gold).float()
    m = (gold >= 0).float()
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.float32) * m
    return (ok * m).sum() / m.sum().clamp_min(1.0)


def mra(pred_value, gold_value, mask=None) -> torch.Tensor:
    """Mean Relative Accuracy over ``MRA_THRESHOLDS`` (VSI-Bench numeric)."""
    pred_value = torch.as_tensor(pred_value, dtype=torch.float32)
    gold_value = torch.as_tensor(gold_value, dtype=torch.float32)
    m = torch.isfinite(gold_value).float()
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.float32) * m
    rel_err = (pred_value - gold_value).abs() / gold_value.abs().clamp_min(1e-9)
    per_thresh = [((rel_err < (1.0 - theta)).float() * m).sum() / m.sum().clamp_min(1.0)
                  for theta in MRA_THRESHOLDS]
    return torch.stack(per_thresh).mean()


def chance_accuracy(n_options, mask=None) -> torch.Tensor:
    """Expected random-guess accuracy given per-sample option counts."""
    n_options = torch.as_tensor(n_options, dtype=torch.float32)
    m = (n_options > 0).float()
    if mask is not None:
        m = torch.as_tensor(mask, dtype=torch.float32) * m
    per = torch.where(n_options > 0, 1.0 / n_options.clamp_min(1.0),
                      torch.zeros_like(n_options))
    return (per * m).sum() / m.sum().clamp_min(1.0)


def per_category_accuracy(pred, gold, cat_id, n_cats: int, mask=None) -> torch.Tensor:
    """[n_cats] masked accuracy per category id; NaN for an empty category."""
    pred, gold = torch.as_tensor(pred), torch.as_tensor(gold)
    cat_id = torch.as_tensor(cat_id)
    ok = (pred == gold).float()
    m = (gold >= 0).float()
    if mask is not None:
        m = m * torch.as_tensor(mask, dtype=torch.float32)
    onehot = (cat_id[:, None] == torch.arange(n_cats)[None, :]).float() * m[:, None]
    hits = (onehot * ok[:, None]).sum(0)
    counts = onehot.sum(0)
    return torch.where(counts > 0, hits / counts.clamp_min(1.0),
                       torch.full_like(counts, float("nan")))


#: Leading articles stripped by open-answer normalization (VQA-style match).
_OPEN_ARTICLES = ("a ", "an ", "the ")


def normalize_open_answer(text: str) -> str:
    """Canonicalize a free-form answer for exact matching: lowercase, strip
    punctuation, collapse whitespace, drop a leading article."""
    t = str(text).strip().lower()
    t = re.sub(r"[^\w\s.%-]", " ", t)
    t = re.sub(r"(?<!\d)\.(?!\d)", " ", t)  # keep "." only inside numbers
    t = re.sub(r"\s+", " ", t).strip()
    for art in _OPEN_ARTICLES:
        if t.startswith(art):
            t = t[len(art):]
            break
    # "42." -> "42", "42.0" -> "42" for numeric-looking strings
    m = re.fullmatch(r"(-?\d+)(?:\.0*)?", t)
    if m:
        t = m.group(1)
    return t


def open_exact_match(pred_text: str, gold_text: str) -> float:
    """1.0 iff the normalized texts match."""
    return float(normalize_open_answer(pred_text) == normalize_open_answer(gold_text))


def blind_report(
    blind_acc: float,
    chance: float,
    full_acc: Optional[float] = None,
    name: str = "",
) -> Dict[str, float]:
    """The headline numbers for one benchmark: blind accuracy, its lift over
    chance, and, with a with-vision accuracy, the vision-blind gap."""
    report = {
        "benchmark": name,
        "blind_accuracy": float(blind_acc),
        "chance_accuracy": float(chance),
        "shortcut_lift": float(blind_acc - chance),
    }
    if full_acc is not None:
        report["full_accuracy"] = float(full_acc)
        report["vision_blind_gap"] = float(full_acc - blind_acc)
    return report
