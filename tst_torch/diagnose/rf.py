"""k-fold Random-Forest shortcut diagnostic, ``diagnose-rf`` (counterpart of
``tst/diagnose/rf.py``).

Fit the auditor forest on hand-crafted features of k-1 folds, predict each
held-out fold, aggregate into s(x) + blind accuracy + feature importances.
The features are derived and, with ``backend="jax"``, the held-out folds
traversed on ``device``; the fit runs on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from tst_torch.data.folds import kfold_assign
from tst_torch.data.schema import BlindDataset
from tst_torch.diagnose.score import bias_scores
from tst_torch.eval import metrics
from tst_torch.features.featurize import FeatureMatrix, featurize
from tst_torch.features.forest import RandomForest


@dataclasses.dataclass
class RFDiagnosis:
    benchmark: str
    s_x: np.ndarray  # [N] bias scores (NaN for non-MCQ rows)
    probs: np.ndarray  # [N, C] held-out option probabilities
    pred: np.ndarray  # [N] held-out predicted option
    fold_id: np.ndarray  # [N]
    blind_accuracy: float
    chance: float
    fold_accuracies: List[float]
    feature_importances: Dict[str, float]  # mean over folds, sorted desc

    def report(self) -> Dict:
        rep = metrics.blind_report(self.blind_accuracy, self.chance, name=self.benchmark)
        rep["fold_accuracies"] = [round(a, 4) for a in self.fold_accuracies]
        rep["top_features"] = dict(list(self.feature_importances.items())[:12])
        return rep


def run_rf_diagnostic(
    ds: BlindDataset,
    *,
    device: torch.device,
    k: int = 5,
    seed: int = 0,
    n_estimators: int = 200,
    max_depth: Optional[int] = 12,
    backend: str = "jax",
    score_rule: str = "gold_prob",
    fold_id: Optional[np.ndarray] = None,
    features: Optional[FeatureMatrix] = None,
) -> RFDiagnosis:
    """Full RF diagnostic: featurize → k-fold fit/predict → s(x) + report.

    ``backend='jax'`` traverses the held-out folds through the packed forest
    on ``device``; ``'sklearn'`` is the host-side parity path. ``fold_id``/
    ``features`` may be supplied by a caller that reuses them.
    """
    fm = features if features is not None else featurize(ds, device=device)
    fid = fold_id if fold_id is not None else kfold_assign(ds, k, seed)
    is_mcq = fm.labels >= 0
    n = fm.n
    max_c = int(fm.labels.max()) + 1 if is_mcq.any() else 1
    # NaN marks rows no fold-model scored (skipped folds, non-MCQ) — they
    # must yield s_x = NaN, never a legitimate-looking 0.0
    probs = np.full((n, max_c), np.nan, np.float32)
    fold_accs: List[float] = []
    importances = np.zeros(fm.dim, np.float64)
    n_fitted = 0
    for f in range(k):
        train = (fid != f) & is_mcq
        hold = (fid == f) & is_mcq
        if train.sum() == 0 or hold.sum() == 0:
            continue
        rf = RandomForest(n_estimators=n_estimators, max_depth=max_depth, seed=seed + f,
                          device=device)
        rf.fit(fm.x[train], fm.labels[train])
        p = rf.predict_proba_full(fm.x[hold], max_c, backend=backend)
        probs[hold] = p
        fold_accs.append(float(metrics.accuracy(p.argmax(-1), fm.labels[hold])))
        importances += rf.feature_importances_
        n_fitted += 1
    if n_fitted == 0:
        raise ValueError("no MCQ samples to diagnose")
    importances /= n_fitted
    scored = np.isfinite(probs).all(-1)
    pred = np.where(scored, np.nan_to_num(probs).argmax(-1), -1).astype(np.int32)
    s_x = bias_scores(np.nan_to_num(probs), fm.labels, fm.n_options, rule=score_rule)
    s_x = np.where(scored, s_x, np.nan)
    blind_acc = float(metrics.accuracy(pred, fm.labels, mask=is_mcq & scored))
    chance = float(metrics.chance_accuracy(fm.n_options))
    order = np.argsort(-importances, kind="stable")
    imp = {fm.names[i]: float(importances[i]) for i in order if importances[i] > 0}
    return RFDiagnosis(
        benchmark=ds.name,
        s_x=s_x,
        probs=probs,
        pred=pred,
        fold_id=fid,
        blind_accuracy=blind_acc,
        chance=chance,
        fold_accuracies=fold_accs,
        feature_importances=imp,
    )
