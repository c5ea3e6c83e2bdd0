#!/usr/bin/env python3
"""Wall of the port's own RF auditor fit (``tst_torch.features.forest``,
CART in numpy on the host) against scikit-learn's ``RandomForestClassifier``
on the same inputs, where scikit-learn is installed.

    python3 scripts/torch_rf_fit_timing.py [--n 512] [--trees 200] [--repeats 3]

The inputs are the auditor's own features of ``synthetic:0.5`` at ``--n``
rows (63 columns), with the reference's forest settings (max_depth 12,
balanced class weights, max_features "sqrt").
Prints one JSON line: the median wall of each fit over ``--repeats``, and
whether the two forests are equal node for node (null without scikit-learn).
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--trees", type=int, default=200)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)

    from tst_torch.data.adapters import load_benchmark
    from tst_torch.features.featurize import featurize
    from tst_torch.features.forest import RandomForest

    host = torch.device("cpu")
    fm = featurize(load_benchmark("synthetic:0.5", n=args.n, seed=0), device=host)
    x, y = fm.x, fm.labels

    def wall(fit):
        times = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            out = fit()
            times.append(time.perf_counter() - t0)
        return statistics.median(times), out

    port_s, port = wall(lambda: RandomForest(n_estimators=args.trees, max_depth=12, seed=0,
                                             device=host).fit(x, y))
    out = {"n": args.n, "features": int(x.shape[1]), "trees": args.trees,
           "port_fit_s": port_s, "sklearn_fit_s": None, "equal_node_for_node": None}
    try:
        from sklearn.ensemble import RandomForestClassifier
    except ImportError:
        print(json.dumps(out))
        return
    sk_s, clf = wall(lambda: RandomForestClassifier(
        n_estimators=args.trees, max_depth=12, random_state=0, class_weight="balanced",
        n_jobs=1).fit(x, y))
    fields = ("children_left", "children_right", "feature", "threshold", "value")
    equal = all(a.node_count == b.tree_.node_count
                and all(np.array_equal(getattr(a, f), getattr(b.tree_, f)) for f in fields)
                for a, b in zip(port.trees_, clf.estimators_))
    out.update(sklearn_fit_s=sk_s, equal_node_for_node=bool(equal))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
