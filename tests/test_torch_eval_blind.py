"""The port's eval-blind slice against the JAX package, and its boundaries.

Weights are the JAX ``init_params`` carried across by tst_torch.bridge; the
data is the synthetic MCQ benchmark. f32 on the CPU.
"""

import ast
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
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.eval import metrics as jmetrics
from tst.models import decoder as jdec
from tst.train import infer as jinfer
from tst.train import pipeline as jpipe
from tst_torch import bridge, cli
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.data.schema import BlindDataset, Sample
from tst_torch.data.tokenize import ByteTokenizer as TByteTokenizer
from tst_torch.eval import metrics as tmetrics
from tst_torch.models.spec import ModelSpec
from tst_torch.train import infer as tinfer
from tst_torch.train import pipeline as tpipe

REPO = Path(__file__).resolve().parent.parent
TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
CPU_TINY = ["--set", "model.name=tiny", "--set", "model.dtype=float32"]


def _port_spec(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _cfg(out_dir, n=48, *extra, config=tconfig):
    """The port's RunConfig; ``config=config_mod`` gives tst's for the JAX side."""
    return config.resolve(None, None, [
        "model.name=tiny", "model.dtype=float32", "data.bench=synthetic:0.5",
        f"data.n={n}", f"out_dir={out_dir}", *extra])


def test_score_all_mcq_matches_reference():
    """Letter probabilities at atol 1e-5 (f32, CPU summation order)."""
    ds = load_benchmark("synthetic:0.5", n=40, seed=1)
    tb = tokenize_dataset(ds, ByteTokenizer())
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(1), TINY))
    want = jinfer.score_all_mcq(params, TINY, jnp.asarray(tb.tokens),
                                jnp.asarray(tb.answer_pos), tb.option_token_ids,
                                tb.n_options)
    for use_pallas in (False, True):
        got = tinfer.score_all_mcq(bridge.to_torch(params), _port_spec(TINY),
                                   torch.from_numpy(tb.tokens),
                                   torch.from_numpy(tb.answer_pos), tb.option_token_ids,
                                   tb.n_options, use_pallas=use_pallas, batch=16)
        assert got.shape == (40, 4)
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_heldout_grid_and_letter_probs_match_reference():
    fold = np.array([0, 1, 1, 2, 0, -1, 2, 2], np.int32)
    idx, valid = tinfer.heldout_index_grid(fold, 3, pad_to=4)
    jidx, jvalid = jinfer.heldout_index_grid(fold, 3, pad_to=4)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(valid, jvalid)
    logits = np.random.default_rng(0).normal(size=(3, 4, 5)).astype(np.float32)
    nopt = np.array([2, 5, 3, 0, 4, 4, 2, 5], np.int32)
    np.testing.assert_array_equal(tinfer.letter_probs(logits, nopt, idx, valid, 8),
                                  jinfer.letter_probs(logits, nopt, idx, valid, 8))
    with pytest.raises(ValueError, match="pad_to"):
        tinfer.heldout_index_grid(fold, 3, pad_to=2)


def test_metrics_match_reference():
    rng = np.random.default_rng(0)
    pred = rng.integers(0, 4, 50)
    gold = rng.integers(-1, 4, 50)
    mask = rng.random(50) > 0.3
    nopt = rng.integers(0, 6, 50)
    pv = rng.normal(5, 2, 50)
    gv = np.where(rng.random(50) > 0.2, rng.normal(5, 2, 50), np.nan)
    pairs = [
        (tmetrics.accuracy(pred, gold), jmetrics.accuracy(pred, gold)),
        (tmetrics.accuracy(pred, gold, mask), jmetrics.accuracy(pred, gold, mask)),
        (tmetrics.chance_accuracy(nopt), jmetrics.chance_accuracy(nopt)),
        (tmetrics.chance_accuracy(nopt, mask), jmetrics.chance_accuracy(nopt, mask)),
        (tmetrics.mra(pv, gv), jmetrics.mra(pv, gv)),
        (tmetrics.mra(pv, gv, mask), jmetrics.mra(pv, gv, mask)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert tmetrics.blind_report(0.4, 0.25, 0.7, "b") == jmetrics.blind_report(0.4, 0.25, 0.7, "b")
    for a, b in [("The Cat.", "cat"), ("42.0", "42"), ("3.5 m", "3.5 m"), ("a", "b")]:
        assert tmetrics.open_exact_match(a, b) == jmetrics.open_exact_match(a, b)
        assert tmetrics.normalize_open_answer(a) == jmetrics.normalize_open_answer(a)


def test_blind_eval_slice_matches_reference(tmp_path, monkeypatch):
    """The whole slice: same dataset, same (bridged) weights → the same
    blind_eval.json, wall time aside."""
    ds = load_benchmark("synthetic:0.5", n=48, seed=0)
    want = jpipe.run_blind_eval(ds, _cfg(tmp_path / "jax", 48, "model.use_pallas=false",
                                          config=config_mod))

    def bridged_model(cfg, tokenizer, device):
        spec = dataclasses.replace(TINY, vocab_size=max(TINY.vocab_size, tokenizer.vocab_size))
        params = jdec.init_params(jax.random.key(cfg.data.seed), spec)
        return _port_spec(spec), bridge.to_torch(jax.tree.map(np.asarray, params), device)

    monkeypatch.setattr(tpipe, "build_model", bridged_model)
    for use_pallas in ("false", "true"):
        out = tmp_path / f"port_{use_pallas}"
        got = tpipe.run_blind_eval(tload_benchmark("synthetic:0.5", n=48, seed=0),
                                   _cfg(out, 48, f"model.use_pallas={use_pallas}"),
                                   torch.device("cpu"))
        with open(out / "blind_eval.json") as f:
            assert json.load(f) == got
        assert sorted(got) == sorted(want)
        for key in want:
            if key != "wall_seconds":
                assert got[key] == pytest.approx(want[key], abs=1e-6), key
        assert got["n_mcq"] == 48 and got["benchmark"] == ds.name


def _bridged_model(quantize):
    def bridged_model(cfg, tokenizer, device):
        spec = dataclasses.replace(TINY, vocab_size=max(TINY.vocab_size, tokenizer.vocab_size))
        params = jdec.init_params(jax.random.key(cfg.data.seed), spec,
                                  quantize=quantize is not None, bits=quantize or 8)
        return _port_spec(spec), bridge.to_torch(jax.tree.map(np.asarray, params), device)

    return bridged_model


@pytest.mark.parametrize("bench,quantize", [
    ("synthetic-vsi:0.4", None), ("synthetic-vsi:0.4", 4), ("synthetic-open", None),
    ("synthetic-numeric", 8),
])
def test_blind_eval_decode_slice_matches_reference(tmp_path, monkeypatch, bench, quantize):
    """The decode-scored legs: MCQ and numeric rows (VSI's mix), open rows,
    an all-numeric set (no MCQ leg); plain, int8 or int4 weights (the same
    bridged JAX init). Every report field within 1e-6, wall time aside."""
    ds = load_benchmark(bench, n=40, seed=0)
    quant = [f"model.quantize=int{quantize}"] if quantize else []
    want = jpipe.run_blind_eval(ds, _cfg(tmp_path / "jax", 40, "model.use_pallas=false", *quant,
                                         config=config_mod))
    monkeypatch.setattr(tpipe, "build_model", _bridged_model(quantize))
    out = tmp_path / "port"
    got = tpipe.run_blind_eval(tload_benchmark(bench, n=40, seed=0), _cfg(out, 40, *quant),
                               torch.device("cpu"))
    with open(out / "blind_eval.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want)
    for key in want:
        if key != "wall_seconds":
            assert got[key] == pytest.approx(want[key], abs=1e-6), key
    n_numeric = sum(s.answer_type == "numeric" for s in ds)
    assert got.get("n_numeric", 0) == n_numeric and got["n_samples"] == 40
    assert ("n_open" in got) == (bench == "synthetic-open")


def test_build_model_quantizes(tmp_path):
    """model.quantize: int8 everywhere, or int4 on the layer matrices whose
    input axis is a multiple of 128 (the rest and the embedding stay int8)."""
    from tst_torch.models import quant as tquant

    tok = TByteTokenizer()
    for bits in ("int8", "int4"):
        spec, params = tpipe.build_model(_cfg(tmp_path, 8, f"model.quantize={bits}"), tok,
                                         torch.device("cpu"))
        layers = params["layers"]
        assert tquant.is_quantized_leaf(params["embed"]) and not tquant.is_int4_leaf(
            params["embed"])
        assert tquant.is_int4_leaf(layers["w_down"]) == (bits == "int4")  # d_ff = 128
        assert not tquant.is_int4_leaf(layers["wq"])  # d_model = 64
        assert not tquant.is_quantized_leaf(layers["attn_norm"])
    with pytest.raises(ValueError, match="unknown model.quantize"):
        tpipe.build_model(_cfg(tmp_path, 8, "model.quantize=int2"), tok, torch.device("cpu"))


def test_platform_gpu_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["eval-blind", "--out", str(tmp_path), *CPU_TINY])


@pytest.mark.parametrize("extra,item", [
    (["perf.spec_draft_model=tiny"], "item 15"), (["model.path=/nonexistent"], "item 3"),
    (["mesh.data=2"], "item 16"),
])
def test_unported_config_raises(tmp_path, extra, item):
    ds = tload_benchmark("synthetic:0.5", n=8, seed=0)
    with pytest.raises(NotImplementedError, match=item):
        tpipe.run_blind_eval(ds, _cfg(tmp_path, 8, *extra), torch.device("cpu"))


def test_unported_rows_and_adapter_raise(tmp_path):
    ds = tload_benchmark("synthetic:0.5", n=8, seed=0)
    with pytest.raises(NotImplementedError, match="item 5"):
        tpipe.run_blind_eval(ds, _cfg(tmp_path), torch.device("cpu"), adapter_dir="x")
    numeric = BlindDataset("n", [Sample(id="0", question="how far?", options=[],
                                        answer="3", answer_type="numeric")])
    with pytest.raises(NotImplementedError, match="item 15"):  # speculative decode
        tpipe.run_blind_eval(numeric, _cfg(tmp_path, 8, "perf.spec_draft_path=/draft"),
                             torch.device("cpu"))


@pytest.mark.parametrize("cmd", sorted(cli.NOT_PORTED))
def test_unported_subcommands_exit_nonzero(cmd, capsys):
    assert cli.main([cmd, "--bench", "synthetic:0.5", "x"]) == 2
    assert f"not yet ported (ROADMAP item {cli.NOT_PORTED[cmd]})" in capsys.readouterr().err


#: top-level packages the port and chip_smoke.py must not import: jax and
#: its kin, the JAX package tst (the port keeps its own copies of tst's
#: jax-free host code, held to tst's by tests/test_torch_host.py), and
#: scikit-learn, which the card's installation lacks (the port fits its own
#: forests)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tst", "sklearn")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "tst_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_port_runs_with_jax_blocked(tmp_path):
    """Every module of the port imports in a process where neither jax, the
    JAX package tst nor scikit-learn can load, and no module of theirs is
    loaded after it. In that process ``diagnose-rf`` and a tiny
    ``diagnose-sft`` under the default RF cross-check run on the CPU: the
    port runs where the card's installation has no scikit-learn."""
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "tst_torch").rglob("*.py") if p.name != "__main__.py")
    rf = ["diagnose-rf", "--platform", "cpu", "--bench", "synthetic:0.5", "--k", "3",
          "--set", "data.n=60", "--set", "rf.n_estimators=20", "--out", str(tmp_path / "rf")]
    sft = ["diagnose-sft", "--platform", "cpu", "--bench", "synthetic:0.5", "--k", "2",
           "--set", "data.n=24", "--set", "optim.batch_size=4", "--set", "optim.epochs=1",
           "--set", "rf.n_estimators=20", *CPU_TINY, "--out", str(tmp_path / "sft")]
    code = (
        "import importlib, importlib.abc, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'tst', 'sklearn')\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in BLOCKED:\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from tst_torch import cli\n"
        f"assert cli.main({rf!r}) == 0\n"
        f"assert cli.main({sft!r}) == 0\n"
        "assert not any(m.split('.')[0] in BLOCKED for m in sys.modules)\n"
        "assert 'tst_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=240,
                   capture_output=True)
    report = json.loads((tmp_path / "sft" / "report.json").read_text())
    assert math.isfinite(report["rf_sft_spearman"]) and "rf_blind_accuracy" in report
    assert json.loads((tmp_path / "rf" / "report.json").read_text())["n_samples"] == 60


def test_cli_subprocess_cpu(tmp_path):
    out = tmp_path / "run"
    proc = subprocess.run(
        [sys.executable, "-m", "tst_torch", "eval-blind", "--platform", "cpu",
         "--bench", "synthetic:0.5", "--set", "data.n=32", *CPU_TINY, "--out", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr
    report = json.loads((out / "blind_eval.json").read_text())
    assert report["n_mcq"] == 32 and math.isfinite(report["blind_accuracy"])
