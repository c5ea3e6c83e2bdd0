"""The port's Iterative Bias Pruning (tst_torch.debias.ibp) against
tst.debias.ibp: the pruning step, the round sizing, the chance helpers and
the resume hash; ``run_ibp`` whole, with the SFT diagnostic (unpacked, with
two seeds and a mid-training snapshot; packed) and with the RF diagnostic;
resume after an injected failure; the planted-bias checks of the reference's
IBP tests on the port's own forest fit.

Both packages get the same weights (the JAX ``init_params``), the same
initial adapters of every round and seed (the JAX ``FoldTrainer.init_state``
for the seed the round asks for), f32 on the CPU. The forests are each
package's own fit: the port's CART against the reference's scikit-learn. Tolerance: 1e-4 on every
number of the reports and the s(x) tables; the splits byte-equal. Set aside:
wall times, and the two places where the port repairs the reference (a NaN
``sx_seed_spearman`` is left out, and a round keeps the stage walls that
measured 0.0).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst import config as config_mod
from tst.data.adapters import load_benchmark
from tst.debias import ibp as jibp
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import sft as jsft
from tst_torch import bridge, cli
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.data.schema import BlindDataset
from tst_torch.data.synthetic import make_synthetic_mcq
from tst_torch.debias import ibp as tibp
from tst_torch.models.spec import ModelSpec
from tst_torch.train import sft as tsft

CPU = torch.device("cpu")
TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
#: a round's stage walls in the audit rows
ROUND_WALLS = {"round_wall_s", "round_setup_s", "round_train_s", "round_mcq_score_s",
               "round_numeric_decode_s", "round_open_decode_s"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's tiny CPU runs issue many small ops: on one thread each they
    do not spin against the other test workers' threads (under a loaded
    host, eight threads a worker made such a run many times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bridge_port(monkeypatch):
    """The port's model and every round's initial adapters become the JAX
    package's."""

    def bridged_model(cfg, tokenizer, device):
        spec = dataclasses.replace(TINY, vocab_size=max(TINY.vocab_size, tokenizer.vocab_size))
        params = jdec.init_params(jax.random.key(cfg.data.seed), spec)
        port_spec = ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})
        return port_spec, bridge.to_torch(jax.tree.map(np.asarray, params), device)

    def bridged_init_state(self, rng):
        spec = dataclasses.replace(TINY, vocab_size=self.spec.vocab_size)
        lspec = jlora.LoraSpec(rank=self.lora_spec.rank, alpha=self.lora_spec.alpha,
                               targets=self.lora_spec.targets, dtype=jnp.float32)
        lora, _ = jsft.FoldTrainer(spec, lspec, self.k).init_state(
            jax.random.key(rng.initial_seed()))
        lora = bridge.to_torch(jax.tree.map(np.asarray, lora), rng.device)
        return lora, self.tx.init(lora)

    monkeypatch.setattr(tibp, "build_model", bridged_model)
    monkeypatch.setattr(tsft.FoldTrainer, "init_state", bridged_init_state)


@pytest.mark.parametrize("seed", range(6))
def test_prune_mask_matches_reference(seed):
    """Random s(x) with NaN rows and ties, random survivors and categories:
    bit-equal masks for every prune rate (a zero budget among them), min_keep
    and with and without category balance."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 90))
    s = rng.random(n).astype(np.float32)
    s[rng.random(n) < 0.15] = 0.5
    s[rng.random(n) < 0.2] = np.nan
    alive = rng.random(n) < 0.85
    cats = rng.integers(0, 4, n)
    for rate in (0.0, 0.01, 0.1, 0.37, 0.9):
        for min_keep in (1, 8, n):
            for c in (None, cats):
                got = tibp.prune_mask(s, alive, rate, categories=c, min_keep=min_keep)
                want = jibp.prune_mask(s, alive, rate, categories=c, min_keep=min_keep)
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bench", ["synthetic:0.5", "synthetic-vsi:0.4", "synthetic-numeric",
                                   "synthetic-open"])
def test_sizing_chance_and_hash_match_reference(tmp_path, bench):
    """round0_sizing at several k and batch sizes, the numeric and open
    chance levels (the degenerate and empty cases too), _nanmean_rows, and
    the resume hash, which ignores ibp.resume and ibp.fail_after_rounds."""
    want_ds, got_ds = load_benchmark(bench, n=40, seed=2), tload_benchmark(bench, n=40, seed=2)
    for over in (["optim.batch_size=6"], ["optim.batch_size=5", "mesh.data=2", "optim.epochs=2"]):
        over = over + [f"out_dir={tmp_path}", "ibp.rounds=2"]
        want_cfg = config_mod.resolve(None, None, over)
        got_cfg = tconfig.resolve(None, None, over)
        for k in (2, 3, 5):
            want = jibp.round0_sizing(want_ds, want_cfg, k)
            assert tibp.round0_sizing(got_ds, got_cfg, k) == want
        assert tibp._ibp_config_hash(got_ds, got_cfg) == jibp._ibp_config_hash(want_ds, want_cfg)
        same = tconfig.resolve(None, None, over + ["ibp.resume=false", "ibp.fail_after_rounds=1"])
        assert tibp._ibp_config_hash(got_ds, same) == tibp._ibp_config_hash(got_ds, got_cfg)
    gold = np.array([s.answer_value if s.answer_type == "numeric" else np.nan for s in got_ds],
                    np.float32)
    texts = [s.answer if s.answer_type == "open" else None for s in got_ds]
    for g in (gold, np.full(4, 7.0, np.float32), np.full(3, np.nan, np.float32)):
        assert tibp._numeric_chance_mra(g) == jibp._numeric_chance_mra(g)
    for t in (texts, [None, None], ["a", "A.", "b", None]):
        assert tibp._open_chance_acc(t) == jibp._open_chance_acc(t)
    rows = [np.where(np.arange(9) % 3 == i, np.nan, np.arange(9.0) * (i + 1)) for i in range(3)]
    rows.append(np.full(9, np.nan))
    np.testing.assert_array_equal(tibp._nanmean_rows(rows), jibp._nanmean_rows(rows))


def _ibp_cfg(config, out_dir, bench, n, *extra):
    return config.resolve(None, None, [
        "model.name=tiny", "model.dtype=float32", f"data.bench={bench}", f"data.n={n}",
        "data.k=2", "data.max_len=128", "optim.batch_size=4", "optim.epochs=1", "ibp.rounds=3",
        "ibp.prune_rate=0.2", "ibp.stop_epsilon=-1", "rf.n_estimators=20",
        f"out_dir={out_dir}", *extra])


def _strict_json(path):
    def no_constant(name):
        raise ValueError(f"{path.name} is not strict JSON: {name}")

    return json.loads(path.read_text(), parse_constant=no_constant)


def _close(got, want, key):
    if isinstance(want, dict):
        assert list(got) == list(want), key
        for k2 in want:
            _close(got[k2], want[k2], f"{key}.{k2}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _close(g, w, key)
    elif isinstance(want, float) and math.isnan(want):
        assert isinstance(got, float) and math.isnan(got), key
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-4), key
    else:
        assert got == want, key


def _assert_reports_match(got, want):
    """``got`` (the port's, strict JSON) against ``want`` (tst's), wall
    times aside; the port leaves a NaN sx_seed_spearman out and keeps the
    round walls of stages that never ran, at 0.0."""
    nan_rho = "sx_seed_spearman" in want and not math.isfinite(want["sx_seed_spearman"])
    assert list(got) == [k for k in want if not (nan_rho and k == "sx_seed_spearman")]
    for key in want:
        if key in ("wall_seconds", "per_round") or key not in got:
            continue
        _close(got[key], want[key], key)
    assert len(got["per_round"]) == len(want["per_round"])
    for g, w in zip(got["per_round"], want["per_round"]):
        assert [k for k in g if k in w] == list(w)
        assert all(k in ROUND_WALLS and g[k] == 0.0 for k in g if k not in w), g
        for key in w:
            if key not in ROUND_WALLS:
                _close(g[key], w[key], f"per_round.{key}")


def _assert_run_dirs_match(got_dir, want_dir):
    want = json.loads((want_dir / "ibp_report.json").read_text())
    got = _strict_json(got_dir / "ibp_report.json")
    _assert_reports_match(got, want)
    for name in ("debiased.jsonl", "removed.jsonl"):
        assert (got_dir / name).read_bytes() == (want_dir / name).read_bytes(), name
    got_rows = [json.loads(x) for x in (got_dir / "sx.jsonl").read_text().splitlines()]
    want_rows = [json.loads(x) for x in (want_dir / "sx.jsonl").read_text().splitlines()]
    assert [list(r) for r in got_rows] == [list(r) for r in want_rows]
    _close(got_rows, want_rows, "sx")
    audit = json.loads((got_dir / "ibp_audit.json").read_text())
    assert [r["round"] for r in audit["rounds"]] == [r["round"] for r in got["per_round"]]
    return got


@pytest.mark.parametrize("bench,n,extra", [
    ("synthetic-vsi:0.4", 32, ["optim.epochs=2", "optim.score_epochs=[1]", "optim.n_seeds=2"]),
    ("synthetic:0.5", 40, ["optim.pack=true"]),
    ("synthetic:0.5", 48, ["ibp.diagnostic=rf"]),
])
def test_run_ibp_matches_reference(tmp_path, monkeypatch, bench, n, extra):
    """The whole loop on the same data, weights and adapters: the
    same ibp_report.json (every round's audit row, stop reason, final sizes,
    the RF cross-check), the same debiased and removed splits, the same s(x)
    table with its kept column. The SFT case also scores an earlier epoch
    and a second seed (sx_seed_spearman) and decodes the numeric rows; the
    packed case packs each round's survivors at their own size."""
    want = jibp.run_ibp(load_benchmark(bench, n=n, seed=0),
                        _ibp_cfg(config_mod, tmp_path / "jax", bench, n, *extra))
    _bridge_port(monkeypatch)
    got = tibp.run_ibp(tload_benchmark(bench, n=n, seed=0),
                       _ibp_cfg(tconfig, tmp_path / "port", bench, n, *extra), CPU)
    report = _assert_run_dirs_match(tmp_path / "port", tmp_path / "jax")
    assert report == json.loads(json.dumps(got))
    assert got["rounds_run"] == want["rounds_run"] >= 2 and got["stop_reason"] == "max_rounds"
    assert "rf_sft_spearman" in got or "ibp.diagnostic=rf" in extra
    if "optim.n_seeds=2" in extra:
        assert all("numeric_mra" in row for row in got["per_round"])


def test_resume_after_failure_equals_one_run(tmp_path):
    """ibp.fail_after_rounds=1 stops after round 0 with its state on disk; a
    second run resumes at round 1 and ends as one uninterrupted run does. A
    state written under another config is not resumed."""
    base = ["--platform", "cpu", "--bench", "synthetic:0.5", "--k", "2",
            "--set", "data.n=32", "--set", "data.max_len=128", "--set", "model.name=tiny",
            "--set", "model.dtype=float32",
            "--set", "optim.batch_size=4", "--set", "optim.epochs=1", "--set", "ibp.rounds=3",
            "--set", "ibp.prune_rate=0.2", "--set", "ibp.stop_epsilon=-1",
            "--set", "rf.cross_check=false"]
    whole, split = tmp_path / "whole", tmp_path / "split"
    assert cli.main(["debias-ibp", *base, "--out", str(whole)]) == 0
    with pytest.raises(RuntimeError, match="injected failure after round 0"):
        cli.main(["debias-ibp", *base, "--set", "ibp.fail_after_rounds=1", "--out", str(split)])
    assert (split / "ibp_state.json").exists()
    assert cli.main(["debias-ibp", *base, "--out", str(split)]) == 0
    got, want = _strict_json(split / "ibp_report.json"), _strict_json(whole / "ibp_report.json")
    assert got.pop("resumed_from_round") == 1 and want.pop("resumed_from_round") is None
    _assert_reports_match(got, want)
    assert not (split / "ibp_state.json").exists()
    for name in ("debiased.jsonl", "removed.jsonl", "sx.jsonl"):
        assert (split / name).read_bytes() == (whole / name).read_bytes(), name

    other = tmp_path / "other"
    with pytest.raises(RuntimeError, match="injected failure"):
        cli.main(["debias-ibp", *base, "--set", "ibp.fail_after_rounds=1", "--out", str(other)])
    assert cli.main(["debias-ibp", *base, "--set", "ibp.prune_rate=0.3", "--set",
                     "ibp.rounds=1", "--out", str(other)]) == 0
    fresh = _strict_json(other / "ibp_report.json")
    assert fresh["resumed_from_round"] is None and fresh["rounds_run"] == 1
    assert fresh["per_round"][0]["n_alive"] == 32


@pytest.mark.parametrize("extra,item", [
    (["model.remat=true"], "item 7"), (["checkpoint_dir=ckpt"], "item 7"),
    (["mesh.data=2"], "item 16"), (["model.path=/nonexistent"], "item 3"),
    (["perf.spec_draft_model=tiny"], "item 15"),
])
def test_unported_config_raises(tmp_path, extra, item):
    ds = tload_benchmark("synthetic:0.5", n=8, seed=0)
    cfg = _ibp_cfg(tconfig, tmp_path, "synthetic:0.5", 8, *extra)
    with pytest.raises(NotImplementedError, match=item):
        tibp.run_ibp(ds, cfg, CPU)


@pytest.mark.parametrize("cmd", ["diagnose-rf", "debias-ibp"])
@pytest.mark.parametrize("flag", [["--profile-dir", "prof"], ["--debug-nans"]])
def test_cli_unported_flags_raise_on_rf_and_ibp(tmp_path, cmd, flag):
    with pytest.raises(NotImplementedError, match="item 17"):
        cli.main([cmd, "--platform", "cpu", *flag, "--out", str(tmp_path)])


def test_ibp_preset_raises_its_items(tmp_path):
    """The ibp-vsibench preset (Llama-3-8B, remat, a 4 x 4 mesh) stops at the
    first thing the port does not have, and names its item."""
    with pytest.raises(NotImplementedError, match="item 16"):
        cli.main(["debias-ibp", "--platform", "cpu", "--preset", "ibp-vsibench",
                  "--bench", "synthetic-vsi:0.4", "--set", "data.n=8", "--out", str(tmp_path)])


# The reference's planted-bias checks of IBP with the RF diagnostic
# (tests/test_ibp.py:70-98, SURVEY §4.4), on the port's own forest fit.

def _rf_cfg(tmp_path, rounds=6, rate=0.15):
    cfg = tconfig.RunConfig()
    cfg.data.k = 3
    cfg.rf.n_estimators = 40
    cfg.ibp.rounds = rounds
    cfg.ibp.prune_rate = rate
    cfg.ibp.stop_epsilon = 0.04
    cfg.ibp.diagnostic = "rf"
    cfg.out_dir = str(tmp_path)
    return cfg


def test_prunes_planted_bias_first(tmp_path):
    ds = make_synthetic_mcq(n=300, bias_fraction=0.4, bias_kind="longest_option", seed=3)
    rep = tibp.run_ibp(ds, _rf_cfg(tmp_path), CPU)
    assert rep["rounds_run"] >= 2
    removed = BlindDataset.load_jsonl(str(tmp_path / "removed.jsonl"))
    kept = BlindDataset.load_jsonl(str(tmp_path / "debiased.jsonl"))
    assert len(removed) + len(kept) == 300
    planted_removed = np.mean([s.meta["planted_bias"] for s in removed])
    planted_kept = np.mean([s.meta["planted_bias"] for s in kept])
    assert planted_removed > 0.7, (planted_removed, rep)
    assert planted_kept < planted_removed


def test_debiased_blind_acc_reaches_chance(tmp_path):
    ds = make_synthetic_mcq(n=300, bias_fraction=0.3, bias_kind="longest_option", seed=5)
    rep = tibp.run_ibp(ds, _rf_cfg(tmp_path, rounds=8, rate=0.12), CPU)
    assert rep["final_blind_accuracy"] <= rep["final_chance"] + 0.08, rep


def test_unbiased_stops_immediately(tmp_path):
    ds = make_synthetic_mcq(n=200, bias_fraction=0.0, seed=0)
    rep = tibp.run_ibp(ds, _rf_cfg(tmp_path), CPU)
    assert rep["stop_reason"] == "blind_acc<=chance+eps"
    assert rep["rounds_run"] <= 2
    assert rep["fraction_kept"] >= 0.8
