"""Rank correlation of two s(x) vectors (counterpart of
``tst.eval.parity.spearman``, which is jax-free but loads jax through its
package)."""

from __future__ import annotations

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
