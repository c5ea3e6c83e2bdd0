# The port's own copy of tst/data/folds.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Deterministic stratified k-fold assignment.

Requirement: "k-fold cross-validation" (reference README.md:35) — each sample
is scored by a model fine-tuned on the other k-1 folds, so the assignment must
be (a) a partition, (b) balanced within strata so fold models see comparable
label/category distributions, and (c) a pure function of (dataset, k, seed)
so reruns and IBP rounds reproduce identical splits.

Implementation is host-side numpy (tiny, runs once); the output is an int32
``fold_id`` vector that lives on-device for the rest of the pipeline
(SURVEY.md §3.3: IBP keeps data device-resident between rounds).
"""

from __future__ import annotations

from typing import List

import numpy as np

from tst_torch.data.schema import BlindDataset


def kfold_assign(ds: BlindDataset, k: int, seed: int = 0) -> np.ndarray:
    """Return ``fold_id[i] in [0, k)`` for each sample, stratified.

    Strata are (category, gold answer) pairs: within each stratum, samples are
    shuffled with a seed derived from (global seed, stratum) and dealt
    round-robin starting at a stratum-dependent offset, so every stratum's
    counts differ across folds by at most one.
    """
    if k < 2:
        raise ValueError(f"k must be >= 2, got {k}")
    n = len(ds)
    if n < k:
        raise ValueError(f"dataset smaller than k: {n} < {k}")
    fold_id = np.full(n, -1, dtype=np.int32)
    strata: dict = {}
    for i, s in enumerate(ds):
        strata.setdefault((s.category, s.answer_type, s.answer), []).append(i)
    for stratum_key in sorted(strata, key=str):
        idx = np.asarray(strata[stratum_key], dtype=np.int64)
        # Stratum-local RNG: stable under addition/removal of other strata.
        # NB: a content hash, NOT Python's hash() — str hashing is salted per
        # process, which would make folds differ across runs/resumes (the
        # leakage-detection tool must never leak via nondeterministic folds).
        import hashlib

        digest = hashlib.sha256(repr((seed, stratum_key)).encode()).digest()
        h = int.from_bytes(digest[:4], "little")
        rng = np.random.default_rng(np.random.SeedSequence([seed, h]))
        rng.shuffle(idx)
        start = int(rng.integers(k))
        for j, i in enumerate(idx):
            fold_id[i] = (start + j) % k
    assert (fold_id >= 0).all()
    return fold_id


def fold_masks(fold_id: np.ndarray, k: int) -> np.ndarray:
    """Boolean train-masks, shape [k, N]: ``masks[f, i]`` is True iff sample i
    is *training* data for fold-model f (i.e. ``fold_id[i] != f``)."""
    return fold_id[None, :] != np.arange(k, dtype=fold_id.dtype)[:, None]


def check_partition(fold_id: np.ndarray, k: int) -> List[int]:
    """Validate the assignment is a partition; return per-fold counts."""
    counts = [int((fold_id == f).sum()) for f in range(k)]
    if sum(counts) != len(fold_id):
        raise AssertionError("fold assignment is not a partition")
    return counts
