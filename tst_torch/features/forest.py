"""The RF auditor's forest (counterpart of ``tst/features/forest.py``).

Fit: the port's own CART forest, grown in numpy on the host as
scikit-learn 1.9.0 grows the reference's ``RandomForestClassifier``
(``tst_torch/features/cart.py``); scikit-learn is not needed.

Inference, two backends under the config's names:

  * ``"jax"`` (``rf.backend``'s default): the trees packed into dense
    tensors on the run's device and traversed all at once, every sample of
    every tree one level per iteration for ``max_depth`` iterations, by
    gathers and selects; leaves loop on themselves; the mean over trees;
  * ``"sklearn"``: the host-side parity path, the same trees traversed in
    numpy with their f64 thresholds, as scikit-learn's ``predict_proba``
    traverses and averages them.

The packed thresholds are the f64 ones rounded down to f32, which makes the
device traversal of f32 features exact (``pack_trees``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from tst_torch.features.cart import TREE_LEAF, grow_forest


@dataclasses.dataclass
class PackedForest:
    """Dense tensor form of a fitted tree ensemble on one device.

    Leaves are encoded as self-looping nodes (left == right == self), so
    traversing ``max_depth`` levels is always safe."""

    feature: torch.Tensor  # int64 [T, M] splitting feature (0 at leaves)
    threshold: torch.Tensor  # float32 [T, M]
    left: torch.Tensor  # int64 [T, M]
    right: torch.Tensor  # int64 [T, M]
    is_leaf: torch.Tensor  # bool [T, M]
    value: torch.Tensor  # float32 [T, M, C] class distribution at node
    max_depth: int

    @property
    def n_classes(self) -> int:
        return self.value.shape[-1]

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """Mean class distribution over trees. x: [N, D] → [N, C]."""
        return forest_predict_proba(self, x)


def forest_predict_proba(f: PackedForest, x: torch.Tensor) -> torch.Tensor:
    """All trees × all samples advance one level per iteration; the mean of
    the reached nodes' class distributions over trees. x: f32 [N, D] on the
    forest's device → f32 [N, C]."""
    t, n = f.feature.shape[0], x.shape[0]
    rows = torch.arange(n, device=x.device)[None, :]
    nodes = torch.zeros((t, n), dtype=torch.long, device=x.device)
    for _ in range(f.max_depth):
        feat = torch.gather(f.feature, 1, nodes)  # [T, N]
        go_left = x[rows, feat] <= torch.gather(f.threshold, 1, nodes)
        nxt = torch.where(go_left, torch.gather(f.left, 1, nodes),
                          torch.gather(f.right, 1, nodes))
        nodes = torch.where(torch.gather(f.is_leaf, 1, nodes), nodes, nxt)
    probs = f.value[torch.arange(t, device=x.device)[:, None], nodes]  # [T, N, C]
    return probs.mean(dim=0)


def pack_trees(trees, n_classes: int, device: torch.device) -> PackedForest:
    """Pack trees in scikit-learn's ``tree_`` layout (the port's own, or a
    fitted scikit-learn forest's) onto ``device``."""
    n_trees = len(trees)
    m = max(tr.node_count for tr in trees)
    feature = np.zeros((n_trees, m), np.int64)
    threshold = np.zeros((n_trees, m), np.float32)
    left = np.zeros((n_trees, m), np.int64)
    right = np.zeros((n_trees, m), np.int64)
    is_leaf = np.ones((n_trees, m), bool)
    value = np.zeros((n_trees, m, n_classes), np.float32)
    max_depth = 1
    for t, tree in enumerate(trees):
        nc = tree.node_count
        leaf = tree.children_left[:nc] == TREE_LEAF
        feature[t, :nc] = np.where(leaf, 0, tree.feature[:nc])
        # the host compares f32 features against f64 thresholds; for exact
        # parity with f32 inputs, use the largest f32 <= the f64 threshold
        # (x <= t64  <=>  x <= round_down32(t64))
        t64 = tree.threshold[:nc]
        t32 = t64.astype(np.float32)
        over = t32.astype(np.float64) > t64
        t32[over] = np.nextafter(t32[over], np.float32(-np.inf), dtype=np.float32)
        threshold[t, :nc] = t32
        self_idx = np.arange(nc)
        left[t, :nc] = np.where(leaf, self_idx, tree.children_left[:nc])
        right[t, :nc] = np.where(leaf, self_idx, tree.children_right[:nc])
        is_leaf[t, :nc] = leaf
        v = tree.value[:nc, 0, :].astype(np.float32)
        value[t, :nc] = v / np.maximum(v.sum(-1, keepdims=True), 1e-12)
        max_depth = max(max_depth, int(tree.max_depth))
    to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
    return PackedForest(feature=to(feature), threshold=to(threshold), left=to(left),
                        right=to(right), is_leaf=to(is_leaf), value=to(value),
                        max_depth=max_depth + 1)


def pack_sklearn_forest(clf, device: torch.device) -> PackedForest:
    """Pack a fitted ``RandomForestClassifier`` (duck-typed on
    ``clf.estimators_[i].tree_`` and ``clf.n_classes_``; imports nothing)."""
    return pack_trees([est.tree_ for est in clf.estimators_], int(clf.n_classes_), device)


def host_predict_proba(trees, x: np.ndarray) -> np.ndarray:
    """scikit-learn's ``predict_proba`` on the same trees: each tree's leaf
    values summed in tree order in f64, over the tree count; f32 features
    compared against the f64 thresholds."""
    x = np.asarray(x, np.float32)
    rows = np.arange(x.shape[0])
    out = np.zeros((x.shape[0], trees[0].value.shape[-1]), np.float64)
    for tree in trees:
        nodes = np.zeros(x.shape[0], np.intp)
        while True:
            left = tree.children_left[nodes]
            inner = left != TREE_LEAF
            if not inner.any():
                break
            feat = np.where(inner, tree.feature[nodes], 0)
            go_left = x[rows, feat] <= tree.threshold[nodes]
            nodes = np.where(inner, np.where(go_left, left, tree.children_right[nodes]), nodes)
        out += tree.value[nodes, 0, :]
    out /= len(trees)
    return out


class RandomForest:
    """Auditor forest: the port's own fit on the host; inference on the
    device (``"jax"``) or the host (``"sklearn"``)."""

    def __init__(
        self,
        *,
        device: torch.device,
        n_estimators: int = 200,
        max_depth: Optional[int] = 12,
        seed: int = 0,
        class_weight: Optional[str] = "balanced",
        max_features="sqrt",
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.seed = seed
        self.class_weight = class_weight
        self.max_features = max_features
        self.device = device
        self.trees_: Optional[List] = None
        self.classes_: Optional[np.ndarray] = None
        self.n_classes_ = 0
        self.feature_importances_: Optional[np.ndarray] = None
        self._packed: Optional[PackedForest] = None

    def fit(self, x: np.ndarray, y: np.ndarray) -> "RandomForest":
        x = np.asarray(x, np.float32)
        classes, y_enc = np.unique(np.asarray(y), return_inverse=True)
        self.classes_ = classes.astype(np.int32)
        self.n_classes_ = len(classes)
        self.trees_ = grow_forest(x, y_enc, self.n_classes_, self.n_estimators, self.max_depth,
                                  self.seed, self.class_weight, self.max_features)
        grown = [t.compute_feature_importances(x.shape[1]) for t in self.trees_
                 if t.node_count > 1]
        if grown:
            imp = np.mean(grown, axis=0, dtype=np.float64)
            self.feature_importances_ = imp / np.sum(imp)
        else:
            self.feature_importances_ = np.zeros(x.shape[1], np.float64)
        self._packed = None
        return self

    def packed(self) -> PackedForest:
        if self._packed is None:
            self._packed = pack_trees(self.trees_, self.n_classes_, self.device)
        return self._packed

    def predict_proba(self, x: np.ndarray, backend: str = "jax") -> np.ndarray:
        """[N, n_classes_seen] class probabilities (columns = ``classes_``)."""
        assert self.trees_ is not None, "fit first"
        if backend == "sklearn":
            return host_predict_proba(self.trees_, x)
        if backend == "jax":
            xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return self.packed().predict_proba(xt).cpu().numpy()
        raise ValueError(f"unknown backend {backend!r}")

    def predict_proba_full(self, x: np.ndarray, n_classes: int, backend: str = "jax") -> np.ndarray:
        """Probabilities scattered into a fixed [N, n_classes] frame (classes
        unseen in training get 0) — folds can see different label subsets."""
        p = self.predict_proba(x, backend)
        out = np.zeros((p.shape[0], n_classes), np.float32)
        out[:, self.classes_] = p
        return out
