"""The numbers that decide ``correct``, each a gap between what the program
produced and what the reference worked out again, and the verdict against
the cell's limits (``portbench/checks/<cell>.json``).

Training (the first steps, which set-up drives through the window's own
call):

* ``loss``: the largest relative gap of a fold's loss at any checked step;
* ``grad``: the first step's gradient as the optimizer got it (the program's
  from its first moment after one step, m₁ / (1 − β₁)), by the worst leaf:
  |‖g_prog‖ − ‖g_ref‖| over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
* ``change``: the adapters' change over the checked steps, by the worst
  leaf in the same way, over the leaves whose first gradient in the
  reference is at least a thousandth of the median leaf's (a leaf the
  reference gives no gradient moves by round-off alone).

A leaf is one fold's A or B of one projection, all layers.

Scoring: ``prob``, the largest gap of a letter's probability over the
sampled rows, every time each of them was scored in the window.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

#: a leaf whose first reference gradient is under this share of the median
#: leaf's is left out of ``change``
QUIET_LEAF = 1e-3


def leaves(trees: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """{"f<fold>.<proj>.<a|b>": tensor} of per-fold adapter trees."""
    return {f"f{f}.{p}.{n}": t for f, tree in enumerate(trees)
            for p, ab in sorted(tree.items()) for n, t in sorted(ab.items())}


def norms(trees: Sequence[Mapping]) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in leaves(trees).items()}


def worst_leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
                   keep: Optional[Sequence[str]] = None) -> float:
    """max over leaves of |got − want| / max(want, median of want)."""
    names = list(keep if keep is not None else want)
    if not names:
        return 0.0
    med = float(np.median([want[n] for n in names]))
    gaps = []
    for n in names:
        den = max(want[n], med)
        gaps.append(abs(got[n] - want[n]) / den if den > 0 else abs(got[n] - want[n]))
    return float(max(gaps))


def moving_leaves(grad1_ref: Mapping[str, float]) -> List[str]:
    med = float(np.median(list(grad1_ref.values())))
    return [n for n, v in grad1_ref.items() if v >= QUIET_LEAF * med]


def train_gaps(got: Mapping, ref: Mapping) -> Dict[str, float]:
    """``got`` and ``ref``: {"losses": [steps][k], "grad1": [k] trees,
    "delta": [k] trees} (the program's, the reference's)."""
    lp = np.asarray(got["losses"], np.float64)
    lr = np.asarray(ref["losses"], np.float64)
    g_ref = norms(ref["grad1"])
    return {"loss": float(np.max(np.abs(lp - lr) / np.abs(lr))),
            "grad": worst_leaf_gap(norms(got["grad1"]), g_ref),
            "change": worst_leaf_gap(norms(got["delta"]), norms(ref["delta"]),
                                     moving_leaves(g_ref))}


def prob_gap(got: Sequence[np.ndarray], want: np.ndarray) -> float:
    """The largest |p_prog − p_ref| over rows and letters; ``got[i]`` holds
    every time row i was scored ([times, C])."""
    return float(max(np.abs(np.asarray(g, np.float64) - want[i][None]).max()
                     for i, g in enumerate(got)))


def load_limits(root: Path, cell: str) -> Dict[str, float]:
    with open(root / "portbench" / "checks" / f"{cell}.json") as f:
        return {k: float(v["limit"]) for k, v in json.load(f)["numbers"].items()}


def verdict(gaps: Mapping[str, float], limits: Mapping[str, float]) -> bool:
    """Every number compared is finite and within its limit; a number with
    no limit, or a limit with no number, is a failure."""
    if set(gaps) != set(limits):
        return False
    return all(np.isfinite(gaps[k]) and gaps[k] <= limits[k] for k in limits)
