"""The port's diagnose-sft slice against tst.train.pipeline.run_sft_diagnostic,
and its boundaries.

Both packages get the same weights (the JAX ``init_params``) and the same
initial adapters (the JAX ``FoldTrainer.init_state`` for the seed the run
asks for), carried across by tst_torch.bridge; folds and batch order come
from the same numpy code. f32 on the CPU, the synthetic MCQ benchmark.
Tolerance: 1e-4 on every number of the report and the s(x) table, wall
times aside (f32 sums in another order over a few optimizer steps).
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst import config as config_mod
from tst.data.adapters import load_benchmark
from tst.diagnose import score as jscore
from tst.eval import metrics as jmetrics
from tst.eval import parity as jparity
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import pipeline as jpipe
from tst.train import sft as jsft
from tst_torch import bridge, cli
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.data.schema import BlindDataset, Sample
from tst_torch.diagnose import score as tscore
from tst_torch.eval import metrics as tmetrics
from tst_torch.eval import parity as tparity
from tst_torch.models.spec import ModelSpec
from tst_torch.train import pipeline as tpipe
from tst_torch.train import sft as tsft

REPO = Path(__file__).resolve().parent.parent
TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
CPU_TINY = ["--set", "model.name=tiny", "--set", "model.dtype=float32"]
#: report fields that are wall-clock times
WALLS = {"wall_seconds", "train_wall_seconds", "train_first_step_seconds",
         "train_samples_per_sec", "setup_wall_seconds", "score_mcq_wall_seconds",
         "numeric_decode_wall_seconds", "open_decode_wall_seconds",
         "rf_cross_check_wall_seconds"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's tiny CPU runs issue many small ops: on one thread each they
    do not spin against the other test workers' threads (under a loaded
    host, eight threads a worker made such a run many times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(out_dir, n=48, *extra, config=tconfig):
    """The port's RunConfig; ``config=config_mod`` gives tst's for the JAX side."""
    return config.resolve(None, None, [
        "model.name=tiny", "model.dtype=float32", "data.bench=synthetic:0.5", f"data.n={n}",
        "data.k=2", "optim.batch_size=4", "optim.epochs=1", "rf.cross_check=false",
        f"out_dir={out_dir}", *extra])


def _jax_spec(tokenizer):
    return dataclasses.replace(TINY, vocab_size=max(TINY.vocab_size, tokenizer.vocab_size))


def _bridge_port(monkeypatch, quantize=None):
    """The port's model (plain, or quantized to ``quantize`` bits) and initial
    adapters become the JAX package's."""

    def bridged_model(cfg, tokenizer, device):
        spec = _jax_spec(tokenizer)
        params = jdec.init_params(jax.random.key(cfg.data.seed), spec,
                                  quantize=quantize is not None, bits=quantize or 8)
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

    monkeypatch.setattr(tpipe, "build_model", bridged_model)
    monkeypatch.setattr(tsft.FoldTrainer, "init_state", bridged_init_state)


def _sx(path):
    with open(path / "sx.jsonl") as f:
        return [json.loads(line) for line in f]


def _assert_close(got, want, key):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), key
        for k2 in want:
            _assert_close(got[k2], want[k2], f"{key}.{k2}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), key
        for g, w in zip(got, want):
            _assert_close(g, w, key)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-4), key
    else:
        assert got == want, key


@pytest.mark.parametrize("n,extra", [
    (48, []),
    (24, ["optim.epochs=2", "optim.score_epochs=[1]", "optim.n_seeds=2"]),
    (48, ["optim.pack=true"]),
    (48, ["rf.cross_check=true", "rf.n_estimators=30"]),
])
def test_diagnose_sft_matches_reference(tmp_path, monkeypatch, n, extra):
    """The whole slice, same data, weights and initial adapters: the same
    report.json and sx.jsonl, wall times aside. The second case adds an
    earlier snapshot to s(x) and a second seed (sx_seed_spearman and
    sx_seed_top_jaccard); the third packs the train rows and the held-out
    rows three samples to a row of 1024 (pack_len, pack_fill_fraction); the
    fourth runs the RF cross-check, the default, with the port's own forest
    fit against the reference's scikit-learn fit (rf_sft_spearman,
    rf_blind_accuracy and its stage wall)."""
    ds = load_benchmark("synthetic:0.5", n=n, seed=0)
    want = jpipe.run_sft_diagnostic(ds, _cfg(tmp_path / "jax", n, "model.use_pallas=false",
                                             *extra, config=config_mod))
    _bridge_port(monkeypatch)
    out = tmp_path / "port"
    got = tpipe.run_sft_diagnostic(tload_benchmark("synthetic:0.5", n=n, seed=0),
                                   _cfg(out, n, *extra), torch.device("cpu"))
    assert list(got) == list(want)
    with open(out / "report.json") as f:
        assert json.load(f) == got
    for key in want:
        if key not in WALLS:
            _assert_close(got[key], want[key], key)
    assert got["n_mcq"] == n and math.isfinite(got["final_loss"])
    if "optim.n_seeds=2" in extra:
        assert "sx_seed_spearman" in got and "sx_seed_top_jaccard" in got
    if "optim.pack=true" in extra:
        assert got["pack_len"] == 1024 and 0.0 < got["pack_fill_fraction"] <= 1.0
    assert ("rf_sft_spearman" in got) == ("rf.cross_check=true" in extra)
    got_sx, want_sx = _sx(out), _sx(tmp_path / "jax")
    assert [list(r) for r in got_sx] == [list(r) for r in want_sx]
    for g, w in zip(got_sx, want_sx):
        _assert_close(g, w, "sx")
    for name in ("dataset.jsonl", "config.json", "events.jsonl"):
        assert (out / name).exists()
    events = [json.loads(line)["event"] for line in (out / "events.jsonl").read_text().splitlines()]
    assert "train" in events and events[-1] == "done"


@pytest.mark.parametrize("bench,quantize,extra", [
    ("synthetic-vsi:0.4", 4, ["model.fused_mlp=true"]),
    ("synthetic-vsi:0.4", None, ["model.fused_mlp=true", 'lora.targets=["gate_proj","q_proj"]']),
    ("synthetic-open", None, []),
    ("synthetic-numeric", None, ["rf.cross_check=true"]),
])
def test_diagnose_sft_decode_slice_matches_reference(tmp_path, monkeypatch, bench, quantize,
                                                     extra):
    """The decode-scored legs after training: numeric rows (VSI's mix) and
    open rows greedy-decoded with each fold's adapter, their s(x) merged
    into the table; int4 weights; ``model.fused_mlp`` (the fused MLP on the
    port's train forward where no adapter targets the MLP, the plain one
    where one does; the reference on the CPU takes its plain MLP). The same
    report.json and sx.jsonl, wall times aside."""
    n = 32
    ds = load_benchmark(bench, n=n, seed=0)
    quant = [f"model.quantize=int{quantize}"] if quantize else []
    want = jpipe.run_sft_diagnostic(ds, _cfg(tmp_path / "jax", n, "model.use_pallas=false",
                                             *quant, *extra, config=config_mod))
    _bridge_port(monkeypatch, quantize)
    out = tmp_path / "port"
    got = tpipe.run_sft_diagnostic(tload_benchmark(bench, n=n, seed=0),
                                   _cfg(out, n, *quant, *extra), torch.device("cpu"))
    assert list(got) == list(want)
    for key in want:
        if key not in WALLS:
            _assert_close(got[key], want[key], key)
    decoded = {"synthetic-open": "open_decode_wall_seconds"}.get(bench,
                                                                 "numeric_decode_wall_seconds")
    assert decoded in got and got["n_samples"] == n
    assert "rf_sft_spearman" not in got and "rf_cross_check_wall_seconds" not in got
    got_sx, want_sx = _sx(out), _sx(tmp_path / "jax")
    assert [list(r) for r in got_sx] == [list(r) for r in want_sx]
    for g, w in zip(got_sx, want_sx):
        _assert_close(g, w, "sx")


def _probs(seed=0, n=40, c=5):
    rng = np.random.default_rng(seed)
    p = rng.random((n, c)).astype(np.float32)
    gold = rng.integers(-1, c, n)
    return p / p.sum(-1, keepdims=True), gold, rng.integers(2, c + 1, n)


@pytest.mark.parametrize("rule", tscore.SCORE_RULES)
def test_bias_scores_match_reference(rule):
    """Bit-equal on the same probabilities (one array, and a list of epochs
    averaged), NaN for non-MCQ rows; the ranking too."""
    probs, gold, nopt = _probs()
    later, _, _ = _probs(seed=1)
    for p in (probs, [probs, later]):
        got = tscore.bias_scores(p, gold, nopt, rule=rule)
        want = jscore.bias_scores(p, gold, nopt, rule=rule)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tscore.rank_by_bias(got), jscore.rank_by_bias(want))
    assert np.isnan(tscore.bias_scores(np.zeros((3, 0), np.float32), gold[:3], nopt[:3])).all()
    with pytest.raises(ValueError, match="unknown score rule"):
        tscore.bias_scores(probs, gold, nopt, rule="entropy")


def test_spearman_and_per_category_accuracy_match_reference():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=50), rng.normal(size=50)
    a[[3, 7]] = np.nan
    assert tparity.spearman(a, b) == jparity.spearman(a, b)
    assert math.isnan(tparity.spearman(np.ones(5), b[:5]))
    assert math.isnan(tparity.spearman(a[:1], b[:1]))
    pred, gold = rng.integers(0, 4, 60), rng.integers(-1, 4, 60)
    cats, mask = rng.integers(0, 5, 60), rng.random(60) > 0.2
    cats[cats == 4] = 3  # category 4 stays empty: NaN
    for m in (None, mask):
        got = tmetrics.per_category_accuracy(pred, gold, cats, 5, mask=m)
        want = jmetrics.per_category_accuracy(pred, gold, cats, 5, mask=m)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7)
        assert math.isnan(got[4].item())


@pytest.mark.parametrize("extra,item", [
    (["model.remat=true"], "item 7"), (["checkpoint_dir=ckpt"], "item 7"),
    (["mesh.data=2"], "item 16"), (["model.path=/nonexistent"], "item 3"),
    (["profile_dir=prof"], "item 17"), (["lora.dropout=0.1"], "item 5"),
    (["perf.spec_draft_model=tiny"], "item 15"),
])
def test_unported_config_raises(tmp_path, extra, item):
    ds = tload_benchmark("synthetic:0.5", n=8, seed=0)
    with pytest.raises(NotImplementedError, match=item):
        tpipe.run_sft_diagnostic(ds, _cfg(tmp_path, 8, *extra), torch.device("cpu"))


def test_decode_scored_rows_raise(tmp_path):
    numeric = BlindDataset("n", [Sample(id=str(i), question="how far?", options=[],
                                        answer="3", answer_type="numeric") for i in range(4)])
    with pytest.raises(NotImplementedError, match="item 15"):  # speculative decode
        tpipe.run_sft_diagnostic(numeric, _cfg(tmp_path, 4, "perf.spec_draft_path=/draft"),
                                 torch.device("cpu"))


def test_cli_unported_flags_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="item 17"):
        cli.main(["diagnose-sft", "--platform", "cpu", "--profile-dir", str(tmp_path)])


def test_cli_subprocess_cpu(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "tst_torch", "diagnose-sft", "--platform", "cpu",
         "--bench", "synthetic:0.5", "--k", "2", "--set", "data.n=32",
         "--set", "optim.batch_size=4", "--set", "optim.epochs=1",
         "--set", "rf.n_estimators=30", *CPU_TINY, "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    report = json.loads((out / "report.json").read_text())
    assert report["n_mcq"] == 32 and report["k"] == 2 and math.isfinite(report["final_loss"])
    assert -1.0 <= report["rf_sft_spearman"] <= 1.0  # the default RF cross-check ran
    rows = _sx(out)
    assert len(rows) == 32 and all(0.0 <= r["s_x"] <= 1.0 for r in rows)
