"""The ``ibp-vsibench`` preset (BASELINE config 5: Llama-3, k=5, full remat,
prune_rate 0.1, the SFT diagnostic) run by the port's ``debias-ibp`` from a
tiny Llama-shaped checkpoint, against tst's ``debias-ibp`` on the same file
and settings: the preset overridden as the card's phase 22 overrides it (the
byte tokenizer, a mesh of one), 2 rounds that always prune, f32 and the plain
attention on the CPU.

Both packages read the same checkpoint; every round's initial adapters are
the JAX ``FoldTrainer.init_state`` draws, carried across by tst_torch.bridge.
Held equal: each round's survivors, the removed ids, the greedy tokens of
every numeric decode; s(x) within 1e-4 (f32 sums in another order over the
k-fold training, as tests/test_torch_ibp.py holds them).
"""

import json

import numpy as np
import pytest
import torch

from test_torch_hf_load import write_hf_checkpoint
from test_torch_hf_pipeline import _bridge_adapters
from tst import config as jconfig
from tst.data.adapters import load_benchmark as jload
from tst.debias import ibp as jibp
from tst.train import infer as jinfer
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload
from tst_torch.debias import ibp as tibp
from tst_torch.train import infer as tinfer

CPU = torch.device("cpu")
N = 40
#: s(x) and the report's numbers: f32 on both sides, sums in another order
SX_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(config, out_dir, ckpt):
    return config.resolve("ibp-vsibench", None, [
        f"model.path={ckpt}", "model.tokenizer=byte", "mesh.data=1", "mesh.tensor=1",
        "data.bench=synthetic-vsi:0.4", f"data.n={N}", "data.max_len=128",
        "optim.epochs=1", "ibp.rounds=2", "ibp.stop_epsilon=-1", "model.dtype=float32",
        "model.use_pallas=false", "rf.n_estimators=20", f"out_dir={out_dir}"])


def _recording(module, store, monkeypatch):
    """Record the greedy tokens of every held-out decode of ``module``."""
    real = module._decode_heldout_rows

    def recorded(*args, **kw):
        gen, idx, valid = real(*args, **kw)
        gen, valid = np.asarray(gen), np.asarray(valid)
        store.append([gen[f][valid[f]].tolist() for f in range(gen.shape[0])])
        return gen, idx, valid

    monkeypatch.setattr(module, "_decode_heldout_rows", recorded)


def _ids(path):
    return [row["id"] for row in map(json.loads, path.read_text().splitlines()) if "id" in row]


def test_ibp_vsibench_preset_matches_reference(tmp_path, monkeypatch):
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", "llama", "BF16")
    want_gen, got_gen = [], []
    _recording(jinfer, want_gen, monkeypatch)
    want = jibp.run_ibp(jload("synthetic-vsi:0.4", n=N, seed=0),
                        _cfg(jconfig, tmp_path / "jax", ckpt))
    _bridge_adapters(monkeypatch)
    _recording(tinfer, got_gen, monkeypatch)
    cfg = _cfg(tconfig, tmp_path / "port", ckpt)
    assert (cfg.data.k, cfg.model.remat, cfg.ibp.prune_rate, cfg.ibp.diagnostic) == (
        5, True, 0.1, "sft")
    got = tibp.run_ibp(tload("synthetic-vsi:0.4", n=N, seed=0), cfg, CPU)

    assert got["rounds_run"] == want["rounds_run"] == 2
    alive = [r["n_alive"] for r in got["per_round"]]
    assert alive == [r["n_alive"] for r in want["per_round"]]
    assert alive[0] == N and alive[1] < N
    removed = _ids(tmp_path / "port" / "removed.jsonl")
    assert removed and removed == _ids(tmp_path / "jax" / "removed.jsonl")
    assert (tmp_path / "port" / "debiased.jsonl").read_bytes() == (
        tmp_path / "jax" / "debiased.jsonl").read_bytes()
    # one decode of the numeric rows a round, the same greedy tokens
    assert len(got_gen) == len(want_gen) == 2 and got_gen == want_gen
    assert sum(len(rows) for rows in got_gen[0]) > 0
    got_rows, want_rows = ([json.loads(x) for x in (tmp_path / d / "sx.jsonl").read_text()
                            .splitlines()] for d in ("port", "jax"))
    assert [(r["id"], r["fold"], r["kept"]) for r in got_rows] == [
        (r["id"], r["fold"], r["kept"]) for r in want_rows]
    sx_got = np.array([np.nan if r["s_x"] is None else r["s_x"] for r in got_rows])
    sx_want = np.array([np.nan if r["s_x"] is None else r["s_x"] for r in want_rows])
    np.testing.assert_allclose(sx_got, sx_want, rtol=0, atol=SX_TOL)
    for g, w in zip(got["per_round"], want["per_round"]):
        for key in ("blind_accuracy", "chance", "numeric_mra"):
            if key in w:
                assert g[key] == pytest.approx(w[key], abs=SX_TOL), key
