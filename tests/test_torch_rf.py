"""The port's RF auditor against tst's and scikit-learn's: features, the
packed forest on the device path and the host path, the port's own CART
forest node for node against scikit-learn 1.9's fit, ``diagnose-rf`` whole
(the port's own fit against the reference's), and the planted-bias checks of
the reference's auditor on the port's own fit.

Tolerances: features at f32, rtol 1e-6 (f32 sums in another order);
probabilities atol 1e-6 on the device path (an f32 mean over trees), equal
bits on the host path; importances atol 1e-12. scikit-learn is imported only
here, never by the port.
"""

import json

import numpy as np
import pytest
import torch
from sklearn.ensemble import RandomForestClassifier

from tst import cli as jcli
from tst.data.adapters import load_benchmark
from tst.diagnose.rf import run_rf_diagnostic as jrun_rf
from tst.features import forest as jforest
from tst.features.featurize import featurize as jfeaturize
from tst_torch import cli
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.data.synthetic import make_synthetic_mcq
from tst_torch.diagnose.rf import run_rf_diagnostic
from tst_torch.diagnose.score import rank_by_bias
from tst_torch.features import featurize as tfeat
from tst_torch.features import forest as tforest

CPU = torch.device("cpu")


def _sklearn(n_estimators=25, max_depth=12, seed=0, max_features="sqrt",
             class_weight="balanced"):
    return RandomForestClassifier(n_estimators=n_estimators, max_depth=max_depth,
                                  random_state=seed, class_weight=class_weight, n_jobs=1,
                                  max_features=max_features)


@pytest.mark.parametrize("bench", ["synthetic:0.5", "synthetic-numeric", "synthetic-vsi:0.4"])
@pytest.mark.parametrize("pinned", [False, True])
def test_featurize_matches_reference(bench, pinned):
    """MCQ, numeric and mixed sets, with the schema of the set or pinned
    (categories and max_opts): the same names bit for bit, the same x."""
    kw = dict(categories=["alpha", "counting", "zeta"], max_opts=6) if pinned else {}
    want = jfeaturize(load_benchmark(bench, n=64, seed=3), **kw)
    got = tfeat.featurize(tload_benchmark(bench, n=64, seed=3), device=CPU, **kw)
    assert got.names == want.names and got.categories == want.categories
    assert got.x.dtype == np.float32 and got.x.shape == want.x.shape
    np.testing.assert_allclose(got.x, want.x, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.n_options, want.n_options)


def _xy(n, d, n_classes, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.integers(0, n_classes, n)
    y[:n_classes] = np.arange(n_classes)
    return x, y


@pytest.mark.parametrize("n_classes,max_depth", [(2, 12), (3, 12), (4, 12), (5, 12), (3, None)])
def test_packed_and_host_predict_match_sklearn(n_classes, max_depth):
    """scikit-learn's fit, packed: the device traversal within 1e-6 of
    predict_proba, the host traversal bit-equal; the packed arrays equal to
    the reference's packing."""
    x, y = _xy(160, 9, n_classes, n_classes)
    clf = _sklearn(max_depth=max_depth).fit(x, y)
    xt, _ = _xy(90, 9, n_classes, 100 + n_classes)
    want = clf.predict_proba(xt)
    packed = tforest.pack_sklearn_forest(clf, CPU)
    got = packed.predict_proba(torch.from_numpy(xt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    trees = [e.tree_ for e in clf.estimators_]
    np.testing.assert_array_equal(tforest.host_predict_proba(trees, xt), want)
    ref = jforest.pack_sklearn_forest(clf)
    assert packed.max_depth == ref.max_depth
    for name in ("feature", "threshold", "left", "right", "is_leaf", "value"):
        np.testing.assert_array_equal(getattr(packed, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize("backend", ["jax", "sklearn"])
def test_class_missing_in_a_fold(backend):
    """A fold that never saw class 1: its column is 0 in the full frame, as
    in the reference's predict_proba_full; the port's own fit against the
    reference's."""
    x, y = _xy(120, 6, 4, 7)
    keep = y != 1
    want_rf = jforest.RandomForest(n_estimators=20, seed=3).fit(x[keep], y[keep])
    got_rf = tforest.RandomForest(n_estimators=20, seed=3, device=CPU).fit(x[keep], y[keep])
    want = want_rf.predict_proba_full(x, 4, backend=backend)
    got = got_rf.predict_proba_full(x, 4, backend=backend)
    assert (got[:, 1] == 0).all() and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got_rf.classes_, want_rf.classes_)


def _trees_equal(got, want):
    assert got.node_count == want.node_count and got.max_depth == want.max_depth
    for name in ("children_left", "children_right", "feature", "threshold", "impurity",
                 "n_node_samples", "weighted_n_node_samples", "value"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


def _featurized(n, seed):
    fm = tfeat.featurize(tload_benchmark("synthetic:0.5", n=n, seed=seed), device=CPU)
    return fm.x, fm.labels


@pytest.mark.parametrize("data,n_estimators,max_features,max_depth,class_weight", [
    ("gauss", 1, None, None, "balanced"), ("gauss", 6, None, 12, "balanced"),
    ("featurized", 8, "sqrt", 12, "balanced"), ("gauss", 3, None, 12, None),
])
def test_own_fit_matches_sklearn_node_for_node(data, n_estimators, max_features, max_depth,
                                               class_weight):
    """The port's CART forest against scikit-learn 1.9's, balanced weights and
    the weighted bootstrap: node for node (structure, features, thresholds,
    impurities, weights, values), the same predictions and importances.
    Continuous Gaussian features under max_features=None, one tree and
    several; the auditor's own features (ties, constant columns) under
    "sqrt", where the splitter's feature draw decides; and the plain
    bootstrap of class_weight=None."""
    x, y = _xy(200, 7, 3, 11) if data == "gauss" else _featurized(160, 4)
    clf = _sklearn(n_estimators, max_depth, seed=5, max_features=max_features,
                   class_weight=class_weight).fit(x, y)
    rf = tforest.RandomForest(n_estimators=n_estimators, max_depth=max_depth, seed=5,
                              class_weight=class_weight, max_features=max_features,
                              device=CPU).fit(x, y)
    assert len(rf.trees_) == n_estimators
    for got, want in zip(rf.trees_, clf.estimators_):
        _trees_equal(got, want.tree_)
    np.testing.assert_allclose(rf.feature_importances_, clf.feature_importances_, atol=1e-12,
                               rtol=0)
    np.testing.assert_array_equal(rf.predict_proba(x, backend="sklearn"), clf.predict_proba(x))
    np.testing.assert_allclose(rf.predict_proba(x, backend="jax"), clf.predict_proba(x),
                               atol=1e-6, rtol=0)


def _run_dir_files(path):
    report = json.loads((path / "report.json").read_text())
    rows = [json.loads(line) for line in (path / "sx.jsonl").read_text().splitlines()]
    return report, rows


def _close(got, want, key):
    if isinstance(want, dict):
        assert list(got) == list(want), key
        for k in want:
            _close(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _close(g, w, key)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-6), key
    else:
        assert got == want, key


@pytest.mark.parametrize("backend", ["jax", "sklearn"])
@pytest.mark.parametrize("bench", ["synthetic:0.5", "synthetic-vsi:0.4"])
def test_diagnose_rf_matches_reference(tmp_path, capsys, backend, bench):
    """``diagnose-rf`` through both CLIs on the same set, an MCQ one and a
    mixed one (numeric rows unscored): the same report.json (wall time
    aside) and sx.jsonl, the port's own fit against scikit-learn's."""
    args = ["diagnose-rf", "--bench", bench, "--k", "3", "--set", "data.n=120",
            "--set", "rf.n_estimators=30", "--set", f"rf.backend={backend}", "--platform", "cpu"]
    assert jcli.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert cli.main(args + ["--out", str(tmp_path / "port")]) == 0
    capsys.readouterr()
    got, got_rows = _run_dir_files(tmp_path / "port")
    want, want_rows = _run_dir_files(tmp_path / "jax")
    got.pop("wall_seconds"), want.pop("wall_seconds")
    _close(got, want, "report")
    assert [list(r) for r in got_rows] == [list(r) for r in want_rows]
    _close(got_rows, want_rows, "sx")
    for name in ("dataset.jsonl", "config.json"):
        assert (tmp_path / "port" / name).exists()


def test_no_mcq_raises():
    ds = tload_benchmark("synthetic-numeric", n=16, seed=0)
    with pytest.raises(ValueError, match="no MCQ samples to diagnose"):
        run_rf_diagnostic(ds, k=2, n_estimators=5, device=CPU)


def test_unscored_rows_are_nan():
    """Non-MCQ rows and rows of folds no model scored keep s(x) = NaN."""
    ds = tload_benchmark("synthetic-vsi:0.4", n=40, seed=1)
    d = run_rf_diagnostic(ds, k=2, n_estimators=10, device=CPU)
    mcq = np.array([s.answer_type == "mcq" for s in ds])
    assert np.isnan(d.s_x[~mcq]).all() and np.isfinite(d.s_x[mcq]).all()
    assert (d.pred[~mcq] == -1).all()
    want = jrun_rf(load_benchmark("synthetic-vsi:0.4", n=40, seed=1), k=2, n_estimators=10)
    np.testing.assert_allclose(d.s_x, want.s_x, atol=1e-6, equal_nan=True)


# The reference's planted-bias checks (tests/test_features_forest.py:163-186,
# SURVEY §4.4) on the port's own fit: the auditor detects planted shortcuts.

def test_biased_benchmark_flagged():
    ds = make_synthetic_mcq(n=400, bias_fraction=1.0, bias_kind="longest_option", seed=0)
    d = run_rf_diagnostic(ds, k=4, seed=0, device=CPU)
    assert d.blind_accuracy > d.chance + 0.3, d.report()
    top5 = list(d.feature_importances)[:5]
    assert any("len" in f or "longest" in f for f in top5), top5


def test_unbiased_benchmark_near_chance():
    ds = make_synthetic_mcq(n=400, bias_fraction=0.0, seed=0)
    d = run_rf_diagnostic(ds, k=4, seed=0, device=CPU)
    assert abs(d.blind_accuracy - d.chance) < 0.12, d.report()


def test_sx_ranks_planted_samples_first():
    ds = make_synthetic_mcq(n=400, bias_fraction=0.5, bias_kind="longest_option", seed=1)
    d = run_rf_diagnostic(ds, k=4, seed=0, device=CPU)
    planted = np.array([s.meta["planted_bias"] for s in ds])
    assert planted[rank_by_bias(d.s_x)[:200]].mean() > 0.7


def test_backends_agree():
    ds = make_synthetic_mcq(n=120, bias_fraction=0.5, seed=2)
    d_host = run_rf_diagnostic(ds, k=3, seed=0, backend="sklearn", n_estimators=30,
                               device=CPU)
    d_dev = run_rf_diagnostic(ds, k=3, seed=0, backend="jax", n_estimators=30, device=CPU)
    np.testing.assert_allclose(d_dev.probs, d_host.probs, atol=1e-6)
    np.testing.assert_array_equal(rank_by_bias(d_dev.s_x), rank_by_bias(d_host.s_x))
