"""The port's subcommands under meshes over several ranks, against one process.

Spawned gloo ranks on the CPU (tests/_torch_mesh_ranks.py) run ``python -m
tst_torch``'s ``main`` with ``--set mesh.*``: ``diagnose-sft`` (MCQ and
decode-scored numeric rows, checkpoints) under (fold=2), (data=2), (seq=2,
the ring) and (tensor=2), and one ``debias-ibp`` round under (data=2); the
held-out greedy and speculative decode under (fold=2), (data=2) and
(tensor=2); and ``torchrun`` itself, the multi-card entry. Rank 0 writes the
artifacts; its s(x) table is the one-process table, byte for byte where the
numbers are bit-equal (the fold axis) and within 1e-5 elsewhere (f32 sums in
another order). The tiny spec in f32.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_ranks import cli_rank, decode_one, decode_rank, run_ranks
from tst_torch import cli
from tst_torch.aux.ckpt import STATE_FILE
from tst_torch.models.hf_load import SafetensorsFile

REPO = Path(__file__).resolve().parent.parent
TINY = ["--platform", "cpu", "--set", "model.name=tiny", "--set", "model.dtype=float32",
        "--set", "data.max_len=128", "--set", "rf.cross_check=false"]
SFT = ["diagnose-sft", "--bench", "synthetic-vsi:0.4", "--k", "2", "--set", "data.n=32",
       "--set", "optim.batch_size=4", "--set", "optim.epochs=1", *TINY]
IBP = ["debias-ibp", "--bench", "synthetic-vsi:0.4", "--k", "2", "--set", "data.n=32",
       "--set", "optim.batch_size=4", "--set", "optim.epochs=1", "--set", "ibp.rounds=1",
       "--set", "ibp.stop_epsilon=-1", *TINY]
MESHES = {"fold=2": (2, 1, 1, 1), "data=2": (1, 2, 1, 1), "seq=2": (1, 1, 2, 1),
          "tensor=2": (1, 1, 1, 2)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh_flags(shape):
    return [a for axis, n in zip(("fold", "data", "seq", "tensor"), shape)
            for a in ("--set", f"mesh.{axis}={n}")]


def _sx(out):
    return [json.loads(line) for line in (out / "sx.jsonl").read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One process, then every mesh's diagnose-sft (with checkpoints) and
    the IBP round, all in one spawn of 2 ranks."""
    root = tmp_path_factory.mktemp("mesh_cli")
    argvs = {}
    for name, shape in MESHES.items():
        argvs[name] = SFT + _mesh_flags(shape) + [
            "--set", f"checkpoint_dir={root / name / 'ck'}", "--out", str(root / name / "run")]
    argvs["ibp"] = IBP + _mesh_flags((1, 2, 1, 1)) + ["--out", str(root / "ibp")]
    # the fold=2 run again over its checkpoints: every rank reads its part back
    argvs["resume"] = SFT + _mesh_flags(MESHES["fold=2"]) + [
        "--set", f"checkpoint_dir={root / 'fold=2' / 'ck'}", "--out", str(root / "resume")]
    torch.set_num_threads(1)
    assert cli.main(SFT + ["--set", f"checkpoint_dir={root / 'one' / 'ck'}",
                           "--out", str(root / "one" / "run")]) == 0
    assert cli.main(IBP + ["--out", str(root / "ibp_one")]) == 0
    rcs = run_ranks(cli_rank, 2, list(argvs.values()))
    assert all(rc == [0] * len(argvs) for rc in rcs)
    return root


@pytest.mark.parametrize("name", list(MESHES))
def test_diagnose_sft_under_a_mesh_matches_one_process(runs, name):
    one, got = _sx(runs / "one" / "run"), _sx(runs / name / "run")
    assert [r["id"] for r in got] == [r["id"] for r in one]
    np.testing.assert_allclose([r["s_x"] for r in got], [r["s_x"] for r in one], atol=1e-5)
    if name == "fold=2":  # the same arithmetic, so the same bytes
        assert (runs / name / "run" / "sx.jsonl").read_bytes() == \
            (runs / "one" / "run" / "sx.jsonl").read_bytes()
    rep, rep1 = (json.loads((p / "report.json").read_text())
                 for p in (runs / name / "run", runs / "one" / "run"))
    assert rep["train_steps"] == rep1["train_steps"] and rep["n_numeric"] == rep1["n_numeric"]
    np.testing.assert_allclose(rep["final_loss"], rep1["final_loss"], rtol=1e-5)
    assert rep["numeric_blind_mra"] == rep1["numeric_blind_mra"]
    # the checkpoint: gathered to rank 0, the one-process file's leaves
    ck, ck1 = (SafetensorsFile(str(p / "ck" / "seed_0_epoch_000" / STATE_FILE))
               for p in (runs / name, runs / "one"))
    assert sorted(ck.keys()) == sorted(ck1.keys())
    for key in ck1.keys():
        np.testing.assert_allclose(ck.get(key).numpy(), ck1.get(key).numpy(), rtol=1e-4,
                                   atol=1e-6)


def test_resume_under_a_mesh_reads_each_ranks_part(runs):
    """A rerun under (fold=2) over the first run's checkpoints resumes every
    epoch at its end: no step runs, and s(x) is the first run's."""
    again = json.loads((runs / "resume" / "report.json").read_text())
    assert again["final_loss"] is None and again["train_steps"] > 0
    assert (runs / "resume" / "sx.jsonl").read_bytes() == \
        (runs / "fold=2" / "run" / "sx.jsonl").read_bytes()


def test_one_ibp_round_under_data_2_keeps_what_one_process_keeps(runs):
    kept = [(runs / d / "debiased.jsonl").read_text() for d in ("ibp", "ibp_one")]
    removed = [(runs / d / "removed.jsonl").read_text() for d in ("ibp", "ibp_one")]
    assert kept[0] == kept[1] and removed[0] == removed[1]
    assert json.loads((runs / "ibp" / "ibp_report.json").read_text())["n_debiased"] < 32


def test_decode_under_a_mesh_equals_one_process():
    """Held-out greedy and speculative tokens (fold-stacked adapters, the
    base as the draft) under (fold=2), (data=2) and (tensor=2): every rank
    returns the one-process tokens."""
    shapes = [MESHES["fold=2"], MESHES["data=2"], MESHES["tensor=2"]]
    one = decode_one((1, 1, 1, 1))
    for rank_out in run_ranks(decode_rank, 2, shapes):
        for got in rank_out:
            for g, w in zip(got, one):
                np.testing.assert_array_equal(g, w)


def test_torchrun_is_the_multi_card_entry(tmp_path):
    """``torchrun --nproc-per-node 2 -m tst_torch diagnose-sft ... --set
    mesh.fold=2``: rank 0 writes the one-process s(x) table. The launcher
    runs in a session of its own, killed with its workers on the deadline."""
    import signal

    from tst_torch.runtime.mesh import free_port

    one = tmp_path / "one"
    assert cli.main(SFT + ["--out", str(one)]) == 0
    out = tmp_path / "two"
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=f"{REPO}{os.pathsep}{env.get('PYTHONPATH', '')}")
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-addr", "127.0.0.1", "--master-port", str(free_port()), "-m", "tst_torch",
         *SFT, *_mesh_flags(MESHES["fold=2"]), "--out", str(out)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, log[-3000:]
    assert (out / "sx.jsonl").read_bytes() == (one / "sx.jsonl").read_bytes()
