"""The port's train-transfer (tst_torch.train.transfer) against tst's, and
the ``train-transfer`` subcommand.

Both packages get the same weights (the JAX ``init_params``) and the same
initial adapter (the JAX ``FoldTrainer.init_state`` for the seed the run
asks for), carried across by tst_torch.bridge, as tests/test_torch_sft.py
and tests/test_torch_diagnose_sft.py do. k=1 with every training row in
the stream, unpacked and packed (``optim.pack``); the eval set mixes MCQ and
numeric rows (synthetic-vsi:0.4), scored with the trained adapter and
zero-shot. Tolerance: 1e-4 on every number of the report, the whole-run
tolerance of the SFT tests (f32 sums in another order over a few steps);
the wall aside.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst import config as config_mod
from tst.data.adapters import load_benchmark
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import pipeline as jpipe
from tst.train import sft as jsft
from tst.train import transfer as jtransfer
from tst_torch import bridge, cli
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.models.spec import ModelSpec
from tst_torch.train import sft as tsft
from tst_torch.train import transfer as ttransfer

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(out_dir, *extra):
    return ["model.name=tiny", "model.dtype=float32", "data.bench=synthetic-vsi:0.4",
            "data.n=16", "data.max_len=128", "optim.batch_size=4", "optim.epochs=1",
            "optim.lr=1e-2", f"out_dir={out_dir}", *extra]


def _bridge_port(monkeypatch):
    """The port's model and initial adapter become the JAX package's."""

    def bridged_model(cfg, tokenizer, device, mesh=None):
        spec, params = jpipe.build_model(config_mod.resolve(None, None, [
            f"model.name={cfg.model.name}", "model.dtype=float32",
            f"data.seed={cfg.data.seed}"]), tokenizer)
        return (ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32}),
                bridge.to_torch(jax.tree.map(np.asarray, params), device))

    def bridged_init_state(self, rng):
        spec = dataclasses.replace(TINY, vocab_size=self.spec.vocab_size)
        lspec = jlora.LoraSpec(rank=self.lora_spec.rank, alpha=self.lora_spec.alpha,
                               targets=self.lora_spec.targets, dtype=jnp.float32)
        lora, _ = jsft.FoldTrainer(spec, lspec, self.k).init_state(
            jax.random.key(rng.initial_seed()))
        lora = bridge.to_torch(jax.tree.map(np.asarray, lora), rng.device)
        return lora, self.tx.init(lora)

    monkeypatch.setattr(ttransfer, "build_model", bridged_model)
    monkeypatch.setattr(tsft.FoldTrainer, "init_state", bridged_init_state)


def _close(got, want, key=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), key
        for k in want:
            _close(got[k], want[k], f"{key}.{k}")
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=1e-4), key
    else:
        assert got == want, key


@pytest.mark.parametrize("pack", [False, True])
def test_train_transfer_matches_reference(tmp_path, monkeypatch, pack):
    _bridge_port(monkeypatch)
    extra = ["optim.pack=true"] if pack else []
    train = ("synthetic:0.5", 16, 99)
    want = jtransfer.run_train_transfer(
        load_benchmark(train[0], n=train[1], seed=train[2]),
        load_benchmark("synthetic-vsi:0.4", n=16, seed=0),
        config_mod.resolve(None, None, _args(tmp_path / "j", *extra)))
    got = ttransfer.run_train_transfer(
        tload_benchmark(train[0], n=train[1], seed=train[2]),
        tload_benchmark("synthetic-vsi:0.4", n=16, seed=0),
        tconfig.resolve(None, None, _args(tmp_path / "t", *extra)), torch.device("cpu"))
    want.pop("wall_seconds")
    got.pop("wall_seconds")
    _close(got, want)
    assert got["experiment"] == "train_transfer" and "zero_shot_numeric_blind_mra" in got
    with open(tmp_path / "t" / "transfer_report.json") as f:
        assert set(json.load(f)) == set(got) | {"wall_seconds"}


def test_train_transfer_cli_cpu(tmp_path):
    out = tmp_path / "tr"
    assert cli.main(["train-transfer", "--platform", "cpu", "--bench", "synthetic-vsi:0.4",
                     "--train-bench", "synthetic:0.5", "--set", "data.n=12",
                     "--set", "model.name=tiny", "--set", "model.dtype=float32",
                     "--set", "data.max_len=128", "--set", "optim.batch_size=4",
                     "--set", "optim.epochs=1", "--out", str(out)]) == 0
    report = json.loads((out / "transfer_report.json").read_text())
    assert report["n_train"] == report["n_eval"] == 12 and report["train_steps"] == 3
    assert np.isfinite(report["final_loss"])
