"""The harness on the CPU at the tiny spec: cells added as data alone run
whole, the comparison passes the port and fails the float8 control and
each planted fault, and nothing loads JAX or the JAX package."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from portbench import compare, harness, run
from portbench.tests import tiny

SEED = 2147483713  # above 32 signed bits, as the driver's are
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp("checkout"))


def _run(root, cell, trace=0, seconds=1.0, seed=SEED):
    args = run.parse(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                      "--trace", str(trace)])
    return run.run(args, device=CPU, root=root, start=time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny.tiny-train", "tiny.tiny-score"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_cell_added_as_data_runs_and_is_correct(root, cell, trace):
    res = _run(root, cell, trace)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    bench = json.loads((root / "BENCHMARK.json").read_text())
    if trace:
        assert res["device"]["window_s"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        kind = "train" if cell.endswith("train") else "score"
        # the CPU trace has no device ops: the readers of the FLOPs and the wall alone
        want = {f"step_mfu.{kind}"} | ({"step_mfu.train_p95", "traced_samples_per_s.train_p95"}
                                       if kind == "train" else set())
        assert set(res["metrics"]) == want
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]}
        assert set(res["metrics"]) == want
        assert all(m["value"] > 0 for m in res["metrics"].values())


def test_the_port_in_float32_matches_the_reference_to_rounding(tmp_path):
    """The same cell with the model in float32: the port and the reference
    compute the same function, so only float32 rounding is left."""
    root = tiny.make_root(tmp_path)
    cfg = json.loads((root / "portbench/configs/tiny.json").read_text())
    cfg["torch_dtype"] = "float32"
    (root / "portbench/configs/tiny.json").write_text(json.dumps(cfg))
    cell = harness.load_cell("tiny.tiny-train", root)
    sess = harness.session(cell, SEED, CPU)
    sess.check_steps()
    gaps = harness.check(sess)
    assert gaps["loss"] < 1e-5 and gaps["grad"] < 1e-4 and gaps["change"] < 1e-3, gaps
    cell = harness.load_cell("tiny.tiny-score", root)
    sess = harness.session(cell, SEED, CPU)
    sess.check_steps()
    harness.timed_window(sess, 0.5)
    assert harness.check(sess)["prob"] < 1e-5


def test_the_float8_control_fails_the_comparison(root):
    limits = compare.load_limits(root, "tiny.tiny-train")
    sess = harness.session(harness.load_cell("tiny.tiny-train", root), SEED, CPU)
    ref = sess.reference()
    control = compare.train_gaps(sess.reference(quant="fp8"), ref)
    assert not compare.verdict(control, limits), control
    limits = compare.load_limits(root, "tiny.tiny-score")
    sess = harness.session(harness.load_cell("tiny.tiny-score", root), SEED, CPU)
    rows = np.arange(16)
    want = sess.reference_probs(rows)
    got = sess.reference_probs(rows, quant="fp8")
    gap = compare.prob_gap([g[None] for g in got], want)
    assert not compare.verdict({"prob": gap}, limits), gap


def _unchanged(step):
    def broken(self, base, lora, opt_state, *arrays):
        losses, _ = self.batch_loss_and_grads(base, lora, *arrays[:4])
        return lora, opt_state, losses
    return broken


def _half_batch(step):
    def broken(self, base, lora, opt_state, tok, mask, pos, idx_kb, segs=None):
        return step(self, base, lora, opt_state, tok, mask, pos,
                    idx_kb[:, : idx_kb.shape[1] // 2], segs)
    return broken


def _token(step):
    def broken(self, base, lora, opt_state, tok, mask, pos, idx_kb, segs=None):
        tok = tok.clone()
        for f in range(idx_kb.shape[0]):
            r = int(idx_kb[f, 0])
            p = int(pos[r]) + 1
            tok[r, p] = (tok[r, p] + 1) % 384
        return step(self, base, lora, opt_state, tok, mask, pos, idx_kb, segs)
    return broken


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _token])
def test_a_broken_train_step_is_not_correct(root, monkeypatch, fault):
    from tst_torch.train.sft import FoldTrainer

    monkeypatch.setattr(FoldTrainer, "step", fault(FoldTrainer.step))
    res = _run(root, "tiny.tiny-train")
    assert not res["correct"], res["checks"]


def _scorer_fault(kind, target_row, n_call, n_pool):
    import tst_torch.train.infer as infer

    score = infer.score_heldout_mcq
    calls = [0]

    def broken(base, lora_k, spec, lspec, tokens, pos, option_ids, n_options, fold_id, k,
               **kw):
        start = (calls[0] % n_pool) * n_call
        calls[0] += 1
        if kind == "half":  # the second half of the call's rows never scored
            fold_id = fold_id.copy()
            fold_id[len(fold_id) // 2:] = -1
        probs = score(base, lora_k, spec, lspec, tokens, pos, option_ids, n_options, fold_id,
                      k, **kw)
        if kind == "answer" and start <= target_row < start + n_call:
            probs = probs.copy()
            probs[target_row - start] = np.roll(probs[target_row - start], 1)
        return probs

    return broken


@pytest.mark.parametrize("kind", ["half", "answer"])
def test_a_broken_scorer_is_not_correct(root, monkeypatch, kind):
    import tst_torch.train.infer as infer

    cell = harness.load_cell("tiny.tiny-score", root)
    sess = harness.session(cell, SEED, CPU)
    sess.check_steps()
    harness.timed_window(sess, 1.0)
    target = int(sess.sample()[0])
    t = tiny.SCORE
    monkeypatch.setattr(infer, "score_heldout_mcq",
                        _scorer_fault(kind, target, t["rows_per_call"], t["pool_calls"]))
    res = _run(root, "tiny.tiny-score")
    assert not res["correct"], res["checks"]


def test_no_module_of_jax_or_the_jax_package_is_loaded(root):
    """A tiny run in a fresh process in which importing jax, jaxlib, flax
    or tst raises; afterwards no such top-level name is in sys.modules."""
    code = textwrap.dedent(f"""
        import importlib.abc, sys, time
        BAD = {{"jax", "jaxlib", "flax", "tst"}}
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BAD:
                    raise ImportError("blocked: " + name)
        for m in [m for m in sys.modules if m.split(".")[0] in BAD]:
            del sys.modules[m]
        sys.meta_path.insert(0, Block())
        import torch
        from pathlib import Path
        from portbench import run
        import portbench.reference.qwen2, portbench.readings
        for cell, trace in (("tiny.tiny-train", 1), ("tiny.tiny-score", 0)):
            args = run.parse(["--workload", cell, "--seed", "5", "--seconds", "0.5",
                              "--trace", str(trace)])
            res = run.run(args, device=torch.device("cpu"), root=Path({str(root)!r}),
                          start=time.perf_counter())
            assert res["correct"], res
        print("LOADED", run.forbidden_modules())
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tiny.REPO), timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout


def test_the_readings_give_a_lower_reading_and_a_higher_control(root, tmp_path, capsys):
    from portbench import readings

    out = tmp_path / "readings.jsonl"
    for cell in ("tiny.tiny-train", "tiny.tiny-score"):
        assert readings.main(["--workload", cell, "--seeds", "11", "--control", "11",
                              "--seconds", "0.5", "--root", str(root), "--device", "cpu",
                              "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    train, score = recs
    assert set(train) >= {"program", "control", "fault_half", "fault_token"}
    assert train["control"]["grad"] > 3 * train["program"]["grad"]
    assert train["fault_half"]["grad"] > 10 * train["program"]["grad"]
    assert score["control"]["prob"] > 3 * score["program"]["prob"]
