"""Whole runs of the port from a local HF checkpoint (``model.path``)
against tst's on the same files: ``eval-blind`` (single-token letters, and a
tokenizer whose letters are two tokens: the multi-token scorer) and
``diagnose-sft`` (under remat, and with chat prompts through a tokenizer
with a chat template), the report and s(x) table at 1e-4, wall times aside
(the tolerance of tests/test_torch_diagnose_sft.py). Then the
``sft-mmmu-llama8b`` preset, overridden as the card's smoke run overrides
it, runs on ``--platform cpu`` from a tiny Llama-shaped checkpoint.

Both packages read the same checkpoint; the port's initial adapters are the
JAX ``FoldTrainer.init_state`` draws, carried across by tst_torch.bridge.
f32 on the CPU.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_diagnose_sft import WALLS, _assert_close, _sx
from test_torch_hf_load import write_hf_checkpoint
from test_torch_host import bpe_tokenizer_dir
from tst import config as jconfig
from tst.data.adapters import load_benchmark as jload
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import pipeline as jpipe
from tst.train import sft as jsft
from tst_torch import bridge, cli
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload
from tst_torch.train import pipeline as tpipe
from tst_torch.train import sft as tsft

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(config, out_dir, ckpt, n, *extra):
    return config.resolve(None, None, [
        f"model.path={ckpt}", "model.dtype=float32", "data.bench=synthetic:0.5", f"data.n={n}",
        "data.k=2", "optim.batch_size=4", "optim.epochs=1", "rf.cross_check=false",
        f"out_dir={out_dir}", *extra])


def _bridge_adapters(monkeypatch):
    """The port's initial adapters become the JAX package's draws."""

    def bridged_init_state(self, rng):
        spec = jdec.ModelSpec(**{**self.spec.__dict__, "dtype": jnp.float32})
        lspec = jlora.LoraSpec(rank=self.lora_spec.rank, alpha=self.lora_spec.alpha,
                               targets=self.lora_spec.targets, dtype=jnp.float32)
        lora, _ = jsft.FoldTrainer(spec, lspec, self.k).init_state(
            jax.random.key(rng.initial_seed()))
        lora = bridge.to_torch(jax.tree.map(np.asarray, lora), rng.device)
        return lora, self.tx.init(lora)

    monkeypatch.setattr(tsft.FoldTrainer, "init_state", bridged_init_state)


@pytest.mark.parametrize("letter_merges", [True, False])
def test_eval_blind_from_checkpoint_matches_reference(tmp_path, letter_merges):
    """eval-blind on a Qwen-shaped checkpoint (tied head, QKV biases, bf16
    on disk) through a BPE tokenizer: one token a letter, or two (the
    multi-token scorer)."""
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", "qwen", "BF16")
    tok = bpe_tokenizer_dir(tmp_path / "tok", letter_merges)
    extra = [f"model.tokenizer={tok}"]
    want = jpipe.run_blind_eval(jload("synthetic:0.5", n=24, seed=0),
                                _cfg(jconfig, tmp_path / "jax", ckpt, 24,
                                     "model.use_pallas=false", *extra))
    got = tpipe.run_blind_eval(tload("synthetic:0.5", n=24, seed=0),
                               _cfg(tconfig, tmp_path / "port", ckpt, 24, *extra), CPU)
    assert list(got) == list(want)
    for key in want:
        if key not in WALLS:
            _assert_close(got[key], want[key], key)
    assert got["n_mcq"] == 24


@pytest.mark.parametrize("family,extra", [
    ("llama", ["model.remat=true"]),
    ("qwen", ["model.remat=dots_flash", "data.prompt_style=chat", "CHAT"]),
])
def test_diagnose_sft_from_checkpoint_matches_reference(tmp_path, monkeypatch, family, extra):
    """diagnose-sft from a Llama-shaped checkpoint (untied head, llama3 RoPE
    scaling) under full remat, and from a Qwen-shaped one under "dots_flash"
    with chat prompts (a tokenizer with a chat template)."""
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", family, "BF16")
    if "CHAT" in extra:
        extra = [e for e in extra if e != "CHAT"] + [
            f"model.tokenizer={bpe_tokenizer_dir(tmp_path / 'tok', chat=True)}"]
    n = 24
    want = jpipe.run_sft_diagnostic(jload("synthetic:0.5", n=n, seed=0),
                                    _cfg(jconfig, tmp_path / "jax", ckpt, n,
                                         "model.use_pallas=false", *extra))
    _bridge_adapters(monkeypatch)
    out = tmp_path / "port"
    got = tpipe.run_sft_diagnostic(tload("synthetic:0.5", n=n, seed=0),
                                   _cfg(tconfig, out, ckpt, n, *extra), CPU)
    assert list(got) == list(want)
    for key in want:
        if key not in WALLS:
            _assert_close(got[key], want[key], key)
    assert math.isfinite(got["final_loss"]) and got["n_mcq"] == n
    got_sx, want_sx = _sx(out), _sx(tmp_path / "jax")
    assert [list(r) for r in got_sx] == [list(r) for r in want_sx]
    for g, w in zip(got_sx, want_sx):
        _assert_close(g, w, "sx")
    assert json.loads((out / "config.json").read_text())["model"]["path"] == ckpt


def test_llama8b_preset_runs_on_cpu(tmp_path):
    """``--preset sft-mmmu-llama8b`` (k=5, batch 8, remat=True), overridden
    as the card's phase 19 overrides it: the checkpoint's geometry, the byte
    tokenizer, a mesh of one, the synthetic benchmark, one epoch (here in
    f32 and at 256 tokens a row: the CPU's dense attention and bf16
    products are slow)."""
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", "llama", "BF16")
    out = tmp_path / "run"
    rc = cli.main(["diagnose-sft", "--platform", "cpu", "--preset", "sft-mmmu-llama8b",
                   "--bench", "synthetic:0.5", "--set", f"model.path={ckpt}",
                   "--set", "model.tokenizer=byte", "--set", "mesh.data=1",
                   "--set", "mesh.tensor=1", "--set", "data.n=50", "--set", "optim.epochs=1",
                   "--set", "data.max_len=256",
                   "--set", "rf.n_estimators=20", "--set", "model.dtype=float32",
                   "--out", str(out)])
    assert rc == 0
    report = json.loads((out / "report.json").read_text())
    cfg = json.loads((out / "config.json").read_text())
    assert report["k"] == 5 and report["n_samples"] == 50 and report["model"] == "llama3-8b"
    assert cfg["model"]["remat"] is True and cfg["optim"]["batch_size"] == 8
    assert report["train_steps"] >= 5  # about 40 train rows a fold, 8 a step
    assert math.isfinite(report["final_loss"]) and math.isfinite(report["rf_sft_spearman"])
