"""Ranking-parity metrics (counterpart of ``tst/eval/parity.py``, which is
jax-free but loads jax through its package): ``spearman``, the rank
correlation of two s(x) vectors, and ``membership_agreement``, our s(x)
ranking against a reference kept/removed split.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation over the pairs where both are finite; NaN
    for fewer than two pairs or a constant side."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ok = np.isfinite(a) & np.isfinite(b)
    if ok.sum() < 2:
        return float("nan")
    if np.all(a[ok] == a[ok][0]) or np.all(b[ok] == b[ok][0]):
        return float("nan")
    from scipy.stats import spearmanr

    rho, _ = spearmanr(a[ok], b[ok])
    return float(rho)


def membership_agreement(
    s_x: np.ndarray,
    sample_ids: Sequence[str],
    reference_kept_ids: Sequence[str],
) -> Dict[str, float]:
    """Compare our s(x) ranking against a reference kept/removed partition.

    Our implied partition keeps the |reference_kept| samples with the LOWEST
    s(x) (least shortcut-exploitable). Returns precision/recall/F1 of our
    removed set vs the reference's, plus the correlation of s(x) with
    removed-ness.
    """
    ids = list(sample_ids)
    s = np.asarray(s_x, np.float32)
    kept_ref = set(reference_kept_ids)
    known = np.array([i in kept_ref for i in ids])
    n_keep = int(known.sum())
    if n_keep == 0 or n_keep == len(ids):
        raise ValueError("reference kept-set does not partition the samples")
    order = np.argsort(np.where(np.isnan(s), -np.inf, s), kind="stable")
    ours_kept = np.zeros(len(ids), bool)
    ours_kept[order[:n_keep]] = True  # lowest s(x) kept
    ref_removed = ~known
    ours_removed = ~ours_kept
    tp = float((ours_removed & ref_removed).sum())
    prec = tp / max(ours_removed.sum(), 1)
    rec = tp / max(ref_removed.sum(), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    # point-biserial: corr(s_x, removed indicator)
    sv = np.where(np.isnan(s), np.nanmean(s), s)
    r = np.corrcoef(sv, ref_removed.astype(np.float32))[0, 1] if len(ids) > 2 else np.nan
    return {
        "removed_precision": round(prec, 4),
        "removed_recall": round(rec, 4),
        "removed_f1": round(f1, 4),
        "sx_removed_pointbiserial": round(float(r), 4),
        "n": len(ids),
        "n_ref_kept": n_keep,
    }
