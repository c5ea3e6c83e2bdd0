"""CART trees for the RF auditor, grown in numpy on the host.

The reference fits its auditor with ``sklearn.ensemble.RandomForestClassifier``
(``tst/features/forest.py:138``); the port must not need scikit-learn, so it
grows the same forest itself, as scikit-learn 1.9.0 grows it
(``sklearn/ensemble/_forest.py``, ``sklearn/tree/_splitter.pyx``,
``_criterion.pyx``, ``_tree.pyx``):

  * tree t's seed is the t-th ``RandomState(seed).randint(2**31 - 1)``;
  * ``class_weight="balanced"`` draws a weighted bootstrap,
    ``RandomState(tree_seed).choice(n, n, p=w / w.sum())`` with
    ``w = n / (n_classes * bincount(y))`` per row, and the tree is fit with
    the draw counts as its sample weights (no class weight multiplies them);
    rows of weight 0 leave the tree;
  * each node visits its candidate features in the splitter's order: a
    Fisher-Yates draw from the xorshift stream ``our_rand_r``
    (``sklearn/utils/_random.pxd``) seeded with
    ``RandomState(tree_seed).randint(0, 2**31 - 1)``, over one feature array
    that persists from node to node, with features found constant (range
    <= 1e-7 in f32) skipped and remembered for the node's descendants;
    ``max_features`` non-constant features are searched ("sqrt":
    ``max(1, int(sqrt(D)))``);
  * a cut lies between two sorted values more than 1e-7 apart; its
    threshold is their midpoint in f64, or the lower value where the
    midpoint rounds onto the upper one; weighted Gini, and the first cut with
    the largest ``-w_r·gini_r - w_l·gini_l`` wins (features in draw order,
    cuts in value order);
  * leaves at ``max_depth``, below two samples, at impurity <= f64 eps, or
    where no cut exists; nodes are numbered depth first, left child first;
    a node's value is its weighted class fractions;
  * importances are the weighted impurity decrease per feature over the
    root's weight, normalised per tree.

The draw counts are integers, so every weighted sum is exact and the search,
vectorised per node (one sort per candidate feature, cumulative class
weights, the Gini of every cut at once), picks the cuts scikit-learn's
sequential scan picks. The feature draw is scikit-learn's own stream: a
scikit-learn release that changes it, or the bootstrap, would grow other
trees (ROADMAP §3).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

#: the splitter's RNG bound and the tie width of two feature values
RAND_R_MAX = 0x7FFFFFFF
FEATURE_THRESHOLD = np.float32(1e-7)
#: impurity at or below this is a pure node
EPSILON = np.finfo(np.float64).eps
TREE_LEAF = -1
TREE_UNDEFINED = -2


class _RandR:
    """scikit-learn's ``our_rand_r`` / ``rand_int``: 32-bit xorshift."""

    def __init__(self, seed: int):
        self.state = int(seed) & 0xFFFFFFFF

    def rand_int(self, low: int, high: int) -> int:
        s = self.state or 1
        s ^= (s << 13) & 0xFFFFFFFF
        s ^= s >> 17
        s ^= (s << 5) & 0xFFFFFFFF
        self.state = s
        return low + (s % (RAND_R_MAX + 1)) % (high - low)


class Tree:
    """One fitted tree in the array layout of scikit-learn's ``tree_``
    (``children_left``/``right`` -1 at leaves, ``feature``/``threshold`` -2
    there, ``value`` [M, 1, C] class fractions), so one packer and one host
    traversal serve both."""

    def __init__(self, n_classes: int):
        self.n_classes = n_classes
        self._nodes: List[tuple] = []
        self._values: List[np.ndarray] = []
        self.max_depth = 0

    def add_node(self, parent: int, is_left: bool, feature: int, threshold: float,
                 impurity: float, n_samples: int, weighted: float, value: np.ndarray) -> int:
        node = len(self._nodes)
        self._nodes.append([TREE_LEAF, TREE_LEAF, feature, threshold, impurity, n_samples,
                            weighted])
        self._values.append(value)
        if parent >= 0:
            self._nodes[parent][0 if is_left else 1] = node
        return node

    def finish(self) -> "Tree":
        cols = list(zip(*self._nodes))
        self.children_left = np.asarray(cols[0], np.intp)
        self.children_right = np.asarray(cols[1], np.intp)
        self.feature = np.asarray(cols[2], np.intp)
        self.threshold = np.asarray(cols[3], np.float64)
        self.impurity = np.asarray(cols[4], np.float64)
        self.n_node_samples = np.asarray(cols[5], np.intp)
        self.weighted_n_node_samples = np.asarray(cols[6], np.float64)
        self.value = np.stack(self._values)[:, None, :]
        self.node_count = len(self._nodes)
        del self._nodes, self._values
        return self

    def compute_feature_importances(self, n_features: int) -> np.ndarray:
        """Weighted impurity decrease per feature over the root's weight,
        normalised to sum 1 (``_tree.pyx`` ``compute_feature_importances``)."""
        imp = np.zeros(n_features, np.float64)
        w, g = self.weighted_n_node_samples, self.impurity
        for node in range(self.node_count):
            left, right = self.children_left[node], self.children_right[node]
            if left != TREE_LEAF:
                imp[self.feature[node]] += (w[node] * g[node] - w[left] * g[left]
                                            - w[right] * g[right])
        imp /= w[0]
        total = np.sum(imp)
        if total > 0.0:
            imp /= total
        return imp


def _gini(counts: np.ndarray, weight: np.ndarray) -> np.ndarray:
    """``1 - Σ_c count_c² / weight²`` over the last axis, summed in class
    order as the criterion sums it."""
    sq = counts[..., 0] * counts[..., 0]
    for c in range(1, counts.shape[-1]):
        sq = sq + counts[..., c] * counts[..., c]
    return 1.0 - sq / (weight * weight)


class _Grower:
    """Grows one tree depth first, with the best splitter."""

    def __init__(self, x: np.ndarray, y: np.ndarray, n_classes: int, weight: np.ndarray,
                 max_depth: Optional[int], max_features: int, rand_seed: int):
        self.x, self.y, self.w = x, y, weight
        self.n_classes = n_classes
        self.max_depth = np.iinfo(np.intp).max if max_depth is None else int(max_depth)
        self.max_features = max_features
        self.rng = _RandR(rand_seed)
        d = x.shape[1]
        self.features = list(range(d))
        self.constant_features = [0] * d
        self.weighted_n_samples = float(np.sum(weight))

    def grow(self) -> Tree:
        tree = Tree(self.n_classes)
        rows = np.flatnonzero(self.w != 0.0)
        # (rows, depth, parent, is_left, impurity, n_constant_features)
        stack = [(rows, 0, -1, False, None, 0)]
        while stack:
            rows, depth, parent, is_left, impurity, n_const = stack.pop()
            counts = np.bincount(self.y[rows], weights=self.w[rows], minlength=self.n_classes)
            weighted = float(counts.sum())
            if impurity is None:
                impurity = float(_gini(counts, weighted))
            split = None
            if not (depth >= self.max_depth or len(rows) < 2 or impurity <= EPSILON):
                split, n_const = self._split(rows, n_const, impurity, weighted, counts)
            if split is None:
                tree.add_node(parent, is_left, TREE_UNDEFINED, float(TREE_UNDEFINED), impurity,
                              len(rows), weighted, counts / weighted)
            else:
                feat, thr, left, right, imp_l, imp_r = split
                node = tree.add_node(parent, is_left, feat, thr, impurity, len(rows), weighted,
                                     counts / weighted)
                stack.append((right, depth + 1, node, False, imp_r, n_const))
                stack.append((left, depth + 1, node, True, imp_l, n_const))
            tree.max_depth = max(tree.max_depth, depth)
        return tree.finish()

    def _draw(self, rows: np.ndarray, n_known: int) -> Tuple[List[int], int]:
        """The node's candidate features in draw order, and the count of
        constant features its children inherit (``node_split_best``'s
        Fisher-Yates loop over the shared feature array)."""
        xs = self.x[rows]
        is_const = xs.max(0) <= xs.min(0) + FEATURE_THRESHOLD
        features, d = self.features, len(self.features)
        f_i, n_found, n_drawn, n_total, n_visited = d, 0, 0, n_known, 0
        drawn = []
        while f_i > n_total and (n_visited < self.max_features
                                 or n_visited <= n_found + n_drawn):
            n_visited += 1
            f_j = self.rng.rand_int(n_drawn, f_i - n_found)
            if f_j < n_known:
                features[n_drawn], features[f_j] = features[f_j], features[n_drawn]
                n_drawn += 1
                continue
            f_j += n_found
            if is_const[features[f_j]]:
                features[f_j], features[n_total] = features[n_total], features[f_j]
                n_found += 1
                n_total += 1
                continue
            f_i -= 1
            features[f_i], features[f_j] = features[f_j], features[f_i]
            drawn.append(features[f_i])
        # the known constants keep their order for siblings and children
        features[:n_known] = self.constant_features[:n_known]
        self.constant_features[n_known:n_total] = features[n_known:n_total]
        return drawn, n_total

    def _split(self, rows, n_known, impurity, weighted, counts):
        """The best cut of the node, or None → (feature, threshold, left rows,
        right rows, left impurity, right impurity), and the children's count
        of known constant features."""
        drawn, n_const = self._draw(rows, n_known)
        if not drawn:
            return None, n_const
        n_f = len(drawn)
        v = self.x[rows[:, None], drawn]  # [m, F] f32
        order = np.argsort(v, axis=0)  # the cuts never fall between equal values
        vs = v[order, np.arange(n_f)]
        ws = self.w[rows[order]]
        # class weights and weight left of each cut p = 1..m-1, then right
        onehot = (self.y[rows[order]][..., None] == np.arange(self.n_classes)) * ws[..., None]
        counts_lr = np.cumsum(onehot[:-1], axis=0)[None].repeat(2, axis=0)
        counts_lr[1] = counts - counts_lr[1]
        w_lr = np.cumsum(ws[:-1], axis=0)[None].repeat(2, axis=0)
        w_lr[1] = weighted - w_lr[1]
        g_lr = _gini(counts_lr, w_lr)
        (w_l, w_r), (g_l, g_r) = w_lr, g_lr
        proxy = -w_r * g_r - w_l * g_l
        proxy[vs[1:] <= vs[:-1] + FEATURE_THRESHOLD] = -np.inf
        best_p = np.argmax(proxy, axis=0)  # first maximum: the scan's strict >
        best = proxy[best_p, np.arange(n_f)]
        f = int(np.argmax(best))
        if not np.isfinite(best[f]):
            return None, n_const
        p = int(best_p[f])
        improvement = ((weighted / self.weighted_n_samples)
                       * (impurity - (w_r[p, f] / weighted * g_r[p, f])
                          - (w_l[p, f] / weighted * g_l[p, f])))
        if improvement + EPSILON < 0.0:
            return None, n_const
        lo, hi = np.float64(vs[p, f]), np.float64(vs[p + 1, f])
        thr = float(lo / 2.0 + hi / 2.0)
        if thr == hi or np.isinf(thr):  # the midpoint rounded onto the upper value
            thr = float(lo)
        left_rows, right_rows = rows[order[: p + 1, f]], rows[order[p + 1:, f]]
        return (drawn[f], thr, left_rows, right_rows, float(g_l[p, f]),
                float(g_r[p, f])), n_const


def balanced_weights(y_enc: np.ndarray, n_classes: int) -> np.ndarray:
    """``compute_sample_weight("balanced", y)``: n / (n_classes · count)."""
    counts = np.bincount(y_enc, minlength=n_classes).astype(np.float64)
    return (float(len(y_enc)) / (n_classes * counts))[y_enc]


def max_features_of(max_features, n_features: int) -> int:
    if max_features is None:
        return n_features
    if max_features == "sqrt":
        return max(1, int(np.sqrt(n_features)))
    raise ValueError(f"unsupported max_features {max_features!r}")


def grow_forest(x: np.ndarray, y_enc: np.ndarray, n_classes: int, n_estimators: int,
                max_depth: Optional[int], seed: int, class_weight: Optional[str] = "balanced",
                max_features="sqrt") -> List[Tree]:
    """``n_estimators`` bootstrapped CART trees on float32 ``x`` [N, D] and
    encoded labels ``y_enc`` [N] (classes 0..n_classes-1)."""
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    if class_weight not in (None, "balanced"):
        raise ValueError(f"unsupported class_weight {class_weight!r}")
    p = None
    if class_weight == "balanced":
        w = balanced_weights(y_enc, n_classes)
        p = w / np.sum(w)
    mf = max_features_of(max_features, d)
    forest_rs = np.random.RandomState(seed)
    trees = []
    for _ in range(n_estimators):
        tree_seed = forest_rs.randint(np.iinfo(np.int32).max)
        draw = np.random.RandomState(tree_seed)
        idx = (draw.randint(0, n, n) if p is None
               else draw.choice(n, n, replace=True, p=p))
        weight = np.bincount(idx, minlength=n).astype(np.float64)
        rand_seed = np.random.RandomState(tree_seed).randint(0, RAND_R_MAX)
        trees.append(_Grower(x, y_enc, n_classes, weight, max_depth, mf, rand_seed).grow())
    return trees
