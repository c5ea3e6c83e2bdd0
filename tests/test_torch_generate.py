"""The port's ``generate`` (tst_torch.train.pipeline.run_generate) against
tst's: plain greedy and exact speculative decode, from the base model or a
served adapter.

Both packages get the same weights (the JAX ``init_params`` for the seed,
the draft's too) through tst_torch.bridge, and the same adapter checkpoint
(tst's Orbax one, and the port's written from the same numpy arrays by
``bridge.save_adapter_checkpoint``). 40 rows decode in chunks of 32, the
tail chunk padded. generations.jsonl must be byte-equal, and the report
equal apart from its walls and the adapter's path (the round and acceptance
counts included); the port adds ``decode_seconds``. f32 on the CPU.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tst import config as config_mod
from tst.aux import ckpt as jckpt
from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer
from tst.train import pipeline as jpipe
from tst.train import sft as jsft
from tst_torch import bridge, cli
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.models.spec import ModelSpec
from tst_torch.train import pipeline as tpipe

CPU = torch.device("cpu")
N = 40
#: walls, and the adapter's path (each package its own checkpoint)
WALLS = {"wall_seconds", "first_call_seconds", "decode_seconds", "adapter"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(out_dir):
    return ["model.name=tiny", "model.dtype=float32", "data.bench=synthetic-vsi:0.4",
            f"data.n={N}", "data.max_len=128", "data.k=2", f"out_dir={out_dir}"]


def _bridged_model(cfg, tokenizer, device, mesh=None):
    """The port's build_model giving the JAX package's weights (the draft's
    too: its config names its geometry)."""
    spec, params = jpipe.build_model(config_mod.resolve(None, None, [
        f"model.name={cfg.model.name}", f"model.dtype={cfg.model.dtype}",
        f"model.quantize={cfg.model.quantize}", f"data.seed={cfg.data.seed}"]), tokenizer)
    return (ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32}),
            bridge.to_torch(jax.tree.map(np.asarray, params), device))


@pytest.fixture(scope="module")
def adapter(tmp_path_factory):
    """(tst's checkpoint, the port's of the same numbers): two folds of
    adapters with B drawn nonzero, AdamW state at step 0."""
    root = tmp_path_factory.mktemp("gen")
    cfg = config_mod.resolve(None, None, _args(root))
    spec, _ = jpipe.build_model(cfg, ByteTokenizer())
    trainer = jsft.FoldTrainer(spec, jpipe.lora_spec_from_cfg(cfg, spec.dtype), 2)
    lora, opt = trainer.init_state(jax.random.key(3))
    rng = np.random.default_rng(3)
    lora = jax.tree.map(np.asarray, lora)
    for ab in lora.values():
        ab["b"] = (0.2 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    extra = trainer.ckpt_extra(step=0)
    jckpt.save_train_state(str(root / "jck"), jax.tree.map(jax.numpy.asarray, lora), opt,
                           extra=extra)
    zeros = jax.tree.map(np.zeros_like, lora)
    bridge.save_adapter_checkpoint(str(root / "tck"), lora, zeros, zeros, 0, extra)
    return str(root / "jck"), str(root / "tck")


CASES = {
    "plain": {},
    "adapter": {"adapter": "0"},
    "self_draft": {"draft_model": "tiny", "gamma": 3},
    "small_draft_adapter_mean": {"draft_model": "small", "gamma": 2, "adapter": "mean"},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_reference(case, adapter, tmp_path, monkeypatch):
    kw = dict(CASES[case])
    fold = kw.pop("adapter", None)
    jdir, tdir = adapter
    monkeypatch.setattr(tpipe, "build_model", _bridged_model)
    want = jpipe.run_generate(
        load_benchmark("synthetic-vsi:0.4", n=N, seed=0),
        config_mod.resolve(None, None, _args(tmp_path / "j")), max_new=6,
        adapter_dir=jdir if fold else None, fold=fold or "0", **kw)
    got = tpipe.run_generate(
        tload_benchmark("synthetic-vsi:0.4", n=N, seed=0),
        tconfig.resolve(None, None, _args(tmp_path / "t")), CPU, max_new=6,
        adapter_dir=tdir if fold else None, fold=fold or "0", **kw)
    assert (tmp_path / "t" / "generations.jsonl").read_bytes() == \
        (tmp_path / "j" / "generations.jsonl").read_bytes()
    assert got["chunk_rows"] == 32 and got["tokens_generated"] == N * 6
    assert {k: v for k, v in got.items() if k not in WALLS} == \
        {k: v for k, v in want.items() if k not in WALLS}
    assert set(got) - set(want) == {"decode_seconds"} and got["decode_seconds"] > 0
    assert got["adapter"] == (tdir if fold else None)
    with open(tmp_path / "t" / "generate_report.json") as f:
        assert json.load(f) == got
    if "draft_model" in kw:
        assert got["spec_rounds"] >= 1 and 0.0 <= got["draft_acceptance"] <= 1.0


def test_generate_cli_speculative_equals_plain(tmp_path):
    """Through the CLI: a draft changes no token, and the report carries
    the acceptance."""
    rows = {}
    for name, extra in (("plain", []), ("spec", ["--draft-model", "tiny", "--gamma", "3"])):
        out = tmp_path / name
        assert cli.main(["generate", "--platform", "cpu", "--bench", "synthetic-numeric",
                         "--set", "data.n=12", "--set", "model.name=tiny",
                         "--set", "model.dtype=float32", "--set", "data.max_len=128",
                         "--max-new", "8", "--out", str(out), *extra]) == 0
        rows[name] = (out / "generations.jsonl").read_bytes()
        report = json.loads((out / "generate_report.json").read_text())
    assert rows["spec"] == rows["plain"]
    assert report["draft"] == "tiny" and report["gamma"] == 3
    assert report["draft_acceptance"] >= 0.7  # the draft is the target
