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

from tst import cli as jcli
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

    def bridged_model(cfg, tokenizer, device, mesh=None):
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
    def bridged_model(cfg, tokenizer, device, mesh=None):
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


@pytest.mark.parametrize("extra,item", [(["mesh.data=2"], "item 16")])
def test_unported_config_raises(tmp_path, extra, item):
    """A mesh above one rank raised ``item`` until meshes were ported; in one
    process it now stops at the rank count, before any work."""
    ds = tload_benchmark("synthetic:0.5", n=8, seed=0)
    with pytest.raises(ValueError, match="mesh 1x2x1x1 needs 2 ranks, have 1"):
        tpipe.run_blind_eval(ds, _cfg(tmp_path, 8, *extra), torch.device("cpu"))


def test_spec_draft_rows_equal_plain(tmp_path):
    """perf.spec_draft_*: the numeric rows decoded by exact speculative
    decode with a draft of another geometry give the plain run's report."""
    ds = tload_benchmark("synthetic-numeric", n=12, seed=0)
    reports = [tpipe.run_blind_eval(ds, _cfg(tmp_path / name, 12, *extra), torch.device("cpu"))
               for name, extra in (("plain", []), ("spec", ["perf.spec_draft_model=small",
                                                            "perf.spec_draft_quantize=none",
                                                            "perf.spec_gamma=3"]))]
    for r in reports:
        r.pop("wall_seconds")
    assert reports[0] == reports[1] and reports[0]["n_numeric"] == 12


def test_missing_adapter_raises(tmp_path):
    ds = tload_benchmark("synthetic:0.5", n=8, seed=0)
    with pytest.raises(FileNotFoundError):
        tpipe.run_blind_eval(ds, _cfg(tmp_path), torch.device("cpu"),
                             adapter_dir=str(tmp_path / "none"))


#: a CPU drive of each subcommand the port gained last, and its artifact
SUBCOMMAND_DRIVES = {
    "generate": (["--bench", "synthetic-vsi:0.4", "--max-new", "4", "--draft-model", "tiny",
                  "--gamma", "2"], "generate_report.json"),
    "train-transfer": (["--bench", "synthetic-vsi:0.4", "--train-bench", "synthetic:0.5",
                        "--set", "optim.batch_size=4", "--set", "optim.epochs=1"],
                       "transfer_report.json"),
    "warmup": (["--bench", "synthetic:0.5", "--k", "2"], "warmup_report.json"),
}


@pytest.mark.parametrize("cmd", sorted(SUBCOMMAND_DRIVES))
def test_ported_subcommands_run_on_cpu(cmd, tmp_path):
    assert cli.NOT_PORTED == {}
    choices = [p._subparsers._group_actions[0].choices
               for p in (jcli.build_parser(), cli.build_parser())]
    assert set(choices[0]) == set(choices[1])  # every subcommand of tst
    extra, artifact = SUBCOMMAND_DRIVES[cmd]
    assert cli.main([cmd, "--platform", "cpu", "--set", "data.n=8", "--set",
                     "data.max_len=128", *CPU_TINY, "--out", str(tmp_path), *extra]) == 0
    report = json.loads((tmp_path / artifact).read_text())
    assert report["n_samples" if cmd != "train-transfer" else "n_eval"] == 8


#: top-level packages the port and chip_smoke.py must not import: jax and
#: its kin, the JAX package tst (the port keeps its own copies of tst's
#: jax-free host code, held to tst's by tests/test_torch_host.py), and
#: scikit-learn, which the card's installation lacks (the port fits its own
#: forests)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tst", "sklearn", "safetensors")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """The port and chip_smoke.py import nothing of FORBIDDEN; the port's
    scripts (scripts/torch_*.py, the spec-decode probe among them) nothing
    of jax or tst (one times the port's forest fit beside scikit-learn's)."""
    files = sorted((REPO / "tst_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert REPO / "scripts" / "torch_probe_spec_decode.py" in scripts
    for path in scripts:
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN[:6], (path, name)


def test_port_runs_with_jax_blocked(tmp_path):
    """Every module of the port imports in a process where neither jax, the
    JAX package tst, scikit-learn nor safetensors can load, and no module of
    theirs is loaded after it. In that process ``diagnose-rf``, a tiny
    ``diagnose-sft`` under the default RF cross-check, checkpointing its
    adapters, an ``eval-blind`` of a checkpoint (``model.path``, read by the
    port's own reader) and one serving those adapters run on the CPU: the
    port runs where the card's installation has no scikit-learn."""
    from test_torch_hf_load import write_hf_checkpoint

    ckpt = write_hf_checkpoint(tmp_path / "ckpt", "qwen", "BF16")
    mods = sorted(".".join(p.relative_to(REPO).with_suffix("").parts)
                  for p in (REPO / "tst_torch").rglob("*.py") if p.name != "__main__.py")
    # the sweep covers the mesh, ring, decode-attention and profiling modules
    # and the entry points of graft_entry
    assert {"tst_torch.runtime.mesh", "tst_torch.kernels.ring_attention",
            "tst_torch.kernels.decode_attention", "tst_torch.aux.profile",
            "tst_torch.aux.flops", "tst_torch.graft_entry"} <= set(mods)
    rf = ["diagnose-rf", "--platform", "cpu", "--bench", "synthetic:0.5", "--k", "3",
          "--set", "data.n=60", "--set", "rf.n_estimators=20", "--out", str(tmp_path / "rf")]
    sft = ["diagnose-sft", "--platform", "cpu", "--bench", "synthetic:0.5", "--k", "2",
           "--set", "data.n=24", "--set", "optim.batch_size=4", "--set", "optim.epochs=1",
           "--set", "rf.n_estimators=20", "--set", f"checkpoint_dir={tmp_path / 'ck'}",
           *CPU_TINY, "--out", str(tmp_path / "sft")]
    blind = ["eval-blind", "--platform", "cpu", "--bench", "synthetic:0.5", "--set", "data.n=16",
             "--set", f"model.path={ckpt}", "--set", "model.dtype=float32",
             "--out", str(tmp_path / "blind")]
    serve = ["eval-blind", "--platform", "cpu", "--bench", "synthetic:0.5", "--set", "data.n=16",
             "--adapter", str(tmp_path / "ck" / "seed_0_epoch_000"), "--fold", "mean",
             *CPU_TINY, "--out", str(tmp_path / "serve")]
    code = (
        "import importlib, importlib.abc, sys\n"
        "BLOCKED = ('jax', 'jaxlib', 'tst', 'sklearn', 'safetensors')\n"
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
        f"assert cli.main({blind!r}) == 0\n"
        f"assert cli.main({serve!r}) == 0\n"
        "assert not any(m.split('.')[0] in BLOCKED for m in sys.modules)\n"
        "assert 'tst_torch' in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=240,
                   capture_output=True)
    report = json.loads((tmp_path / "sft" / "report.json").read_text())
    assert math.isfinite(report["rf_sft_spearman"]) and "rf_blind_accuracy" in report
    served = json.loads((tmp_path / "serve" / "blind_eval.json").read_text())
    assert served["zero_shot"] is False and served["adapter_fold"] == "mean"
    assert json.loads((tmp_path / "rf" / "report.json").read_text())["n_samples"] == 60
    assert json.loads((tmp_path / "blind" / "blind_eval.json").read_text())["n_mcq"] == 16


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
