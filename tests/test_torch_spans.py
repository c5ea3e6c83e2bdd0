"""The stage spans of ``tst_torch.aux.profile`` (``span``, ``recording``,
``take``), where the train step and the scorer open them, their clock
against a profiler trace's, and the card's time attributed to them
(``portbench/spans.py``) on a hand-built trace and on a tiny CPU cell.

CPU runs at the ``tiny`` spec in f32.
"""

import dataclasses
import io
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness, spans
from portbench.tests import tiny
from tst_torch.aux import profile
from tst_torch.models.decoder import init_params
from tst_torch.models.lora import LoraSpec
from tst_torch.models.spec import spec_by_name
from tst_torch.train import infer
from tst_torch.train import sft

REPO = Path(__file__).resolve().parents[1]
TINY = dataclasses.replace(spec_by_name("tiny"), dtype=torch.float32)
LSPEC = LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
K, B, S, N = 2, 3, 32, 12

TRAIN_TREE = [  # (name, parent's name, kind) in the order they open
    ("train.step", None, "work"),
    ("train.rows", "train.step", "work"),
    ("train.rows.to_device", "train.rows", "wait"),
    ("train.forward", "train.step", "work"),
    ("train.backward", "train.step", "work"),
    ("train.optimizer", "train.step", "work"),
]


@pytest.fixture(autouse=True)
def _one_thread_and_no_spans_kept():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    profile.take()  # those an earlier test's recording kept
    yield
    torch.set_num_threads(threads)
    profile.take()


@pytest.fixture(scope="module")
def rows():
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, TINY.vocab_size, (N, S), generator=g)
    mask = torch.zeros(N, S)
    mask[:, S // 2:] = 1.0
    pos = torch.full((N,), S // 2 - 1, dtype=torch.long)
    return init_params(g, TINY), tokens, mask, pos


def _trainer():
    trainer = sft.FoldTrainer(TINY, LSPEC, K, t_max=2)
    lora, state = trainer.init_state(torch.Generator().manual_seed(1))
    return trainer, lora, state


def _step(rows, trainer, lora, state, t=0):
    params, tokens, mask, pos = rows
    idx = np.arange(K * B).reshape(K, B) + t
    return trainer.step(params, lora, state, tokens, mask, pos, idx)


def _score(rows):
    params, tokens, _, pos = rows
    lora = _trainer()[1]
    return infer.score_heldout_mcq(params, lora, TINY, LSPEC, tokens, pos,
                                   np.array([3, 5, 7, 9]), np.full(N, 4), np.arange(N) % K, K,
                                   batch=4)


def _tree(recs):
    by_id = {r["id"]: r for r in recs}
    return [(r["name"], None if r["parent"] is None else by_id[r["parent"]]["name"], r["kind"])
            for r in recs]


def test_off_records_nothing_and_returns_the_shared_no_op(rows, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("read while spans are off")

    monkeypatch.setattr(profile.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profile.span("train.step", unit=3) is profile.span("x", kind="wait", bytes=8)
    with profile.span("a") as s:
        assert s is profile._OFF
    trainer, lora, state = _trainer()
    _step(rows, trainer, lora, state)
    _score(rows)
    assert profile.take() == []


def test_under_trace_a_span_is_a_bar_and_is_not_kept(rows, tmp_path):
    trainer, lora, state = _trainer()
    with profile.trace(str(tmp_path)):
        _step(rows, trainer, lora, state)
    assert profile.take() == []
    events = json.loads((tmp_path / profile.TRACE_FILE).read_text())["traceEvents"]
    bars = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(bars) == sorted(name for name, _, _ in TRAIN_TREE)
    assert profile.span("a") is profile._OFF


def test_nesting_gives_the_parent_and_the_unit():
    with profile.recording():
        with profile.span("a", unit=7):
            with profile.span("b", kind="wait", bytes=16):
                with profile.span("c", unit=9):
                    pass
            with profile.span("d"):
                pass
        with profile.span("e"):
            pass
    recs = profile.take()
    assert _tree(recs) == [("a", None, "work"), ("b", "a", "wait"), ("c", "b", "work"),
                           ("d", "a", "work"), ("e", None, "work")]
    assert [r["unit"] for r in recs] == [7, 7, 9, 7, None]
    assert recs[1]["attrs"] == {"bytes": 16}
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
    assert recs[0]["start_ns"] <= recs[1]["start_ns"] <= recs[1]["end_ns"] <= recs[0]["end_ns"]
    assert profile.take() == []


def test_spans_kept_earlier_are_dropped_by_a_new_recording():
    with profile.recording():
        with profile.span("old"):
            pass
    with profile.recording():
        with profile.span("new"):
            pass
    assert [r["name"] for r in profile.take()] == ["new"]


def test_the_train_step_records_its_stages_in_order_with_one_unit(rows):
    trainer, lora, state = _trainer()
    with profile.recording():
        lora, state, _ = _step(rows, trainer, lora, state)
        _step(rows, trainer, lora, state, t=1)
    recs = profile.take()
    assert _tree(recs) == TRAIN_TREE * 2
    assert [r["unit"] for r in recs] == [0] * 6 + [1] * 6
    assert recs[2]["attrs"] == {"bytes": 8 * K * B}
    for a, b in zip(recs[3:5], recs[4:6]):  # forward, backward, optimizer back to back
        assert a["end_ns"] <= b["start_ns"]


def test_the_scorer_records_its_call_rows_chunks_copy_and_probabilities(rows):
    with profile.recording():
        _score(rows)
        _score(rows)
    recs = profile.take()
    first = [r for r in recs if r["unit"] == recs[0]["unit"]]
    chunks = K * 2  # each fold's six held-out rows, padded to two chunks of four
    assert _tree(first) == ([("score.call", None, "work"), ("score.rows", "score.call", "work")]
                            + [("score.rows.to_device", "score.rows", "wait")] * 2
                            + [("score.chunk", "score.call", "work")] * chunks
                            + [("score.to_host", "score.call", "wait"),
                               ("score.probs", "score.call", "work")])
    assert [r["attrs"] for r in first if r["name"] == "score.chunk"] == [
        {"fold": 0, "rows": 4}, {"fold": 0, "rows": 4}, {"fold": 1, "rows": 4},
        {"fold": 1, "rows": 4}]
    assert first[-2]["attrs"] == {"bytes": K * (N // K) * 4 * 4}  # [k, M, C] f32
    assert len(recs) == 2 * len(first) and recs[len(first)]["unit"] == recs[0]["unit"] + 1


def test_the_spans_lie_on_the_profiler_trace_clock(rows, tmp_path):
    trainer, lora, state = _trainer()
    _step(rows, trainer, lora, state)
    with profile.trace(str(tmp_path)), profile.recording():
        _step(rows, trainer, lora, state, t=1)
    doc = json.loads((tmp_path / profile.TRACE_FILE).read_text())
    recs = spans.on_trace_clock(profile.take(), int(doc["baseTimeNanoseconds"]))
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    bars = {e["name"]: e for e in events if e.get("cat") == "user_annotation"}
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert [r["name"] for r in recs] == [name for name, _, _ in TRAIN_TREE]
    slack = 1000.0  # µs
    for r in recs:
        bar = bars[r["name"]]
        a, b = float(bar["ts"]), float(bar["ts"]) + float(bar["dur"])
        assert r["start_us"] - slack <= a <= b <= r["end_us"] + slack
        inside = [e for e in ops if a <= float(e["ts"]) < b]
        assert inside or r["name"] == "train.rows.to_device"
        for e in inside:
            assert r["start_us"] - slack <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= r["end_us"] + slack


# -- the attribution, on a hand-built trace (times in ms, written in µs) ------------------

BASE_NS = 1_790_000_000_000_000_000
TRAIN_SPANS = [  # name, kind, start, end, parent
    ("train.step", "work", 2, 98, None), ("train.rows", "work", 2, 20, 0),
    ("train.rows.to_device", "wait", 5, 15, 1), ("train.forward", "work", 20, 50, 0),
    ("train.backward", "work", 50, 80, 0), ("train.optimizer", "work", 80, 95, 0)]
TRAIN_DEVICE = [  # name, category, start, end, launch at, launch category, launch thread
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 12, 14, 10, "cuda_runtime", 1),
    ("index_kernel", "kernel", 20, 22, 17, "cuda_runtime", 1),
    ("gemm_a", "kernel", 25, 35, 25, "cuda_runtime", 1),
    ("gemm_b", "kernel", 33, 45, 30, "cuda_driver", 1),
    ("gemm_b_backward", "kernel", 55, 75, 55, "cuda_runtime", 2),  # autograd's thread
    ("late_forward_kernel", "kernel", 76, 80, 48, "cuda_runtime", 1),  # ran in backward's time
    ("at::native::sqrt_kernel_cuda", "kernel", 85, 90, 85, "cuda_runtime", 1),
    # dropped: launched before the window, and after it though it runs inside
    ("kernel_of_the_block_before", "kernel", -20, -10, -25, "cuda_runtime", 1),
    ("kernel_of_the_block_after", "kernel", 99, 99.5, 100.5, "cuda_runtime", 1)]
# busy [12,14] [20,22] [25,45] [55,75] [76,80] [85,90] in the window [0,100]: gaps
# [0,12) outside every span, [14,20) under the wait, and dispatch idle [22,25) and
# [45,55) under train.forward, [75,76) under train.backward, [80,85) and [90,100)
# under train.optimizer: 3 + 10 + 1 + 5 + 10
TRAIN_WANT = {"forward_ms_per_step": 24.0, "backward_ms_per_step": 20.0,
              "optimizer_ms_per_step": 5.0, "host_wait_ms_per_step": 10.0,
              "dispatch_idle_ms_per_step": 29.0}
SCORE_SPANS = [
    ("score.call", "work", 2, 98, None), ("score.rows", "work", 2, 10, 0),
    ("score.rows.to_device", "wait", 3, 8, 1), ("score.chunk", "work", 10, 40, 0),
    ("score.chunk", "work", 40, 70, 0), ("score.to_host", "wait", 70, 90, 0),
    ("score.probs", "work", 90, 95, 0)]
SCORE_DEVICE = [
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 6, 7, 5, "cuda_runtime", 1),
    ("gemm", "kernel", 15, 35, 12, "cuda_runtime", 1),
    ("gemm", "kernel", 42, 60, 42, "cuda_runtime", 1),
    ("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 71, 72, 71, "cuda_runtime", 1)]
# gaps: [0,6) outside, [7,15) and [72,100) waiting, [35,42) and [60,71) under the chunks;
# the host waits [3,8) and [70,90)
SCORE_WANT = {"forward_ms_per_call": 38.0, "dispatch_idle_ms_per_call": 18.0,
              "host_wait_ms_per_call": 25.0}


def _hand_built(tmp_path, span_rows, device_rows, units=1):
    events = [{"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1000.0, "dur": 5.0,
               "tid": 1}]
    for i, (name, cat, a, b, launch, lcat, tid) in enumerate(device_rows):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": a * 1e3, "dur": (b - a) * 1e3,
                       "args": {"correlation": 100 + i}})
        events.append({"ph": "X", "cat": lcat, "name": "cudaLaunchKernel", "ts": launch * 1e3,
                       "dur": 4.0, "tid": tid, "args": {"correlation": 100 + i}})
    events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaDeviceSynchronize",
                   "ts": 97e3, "dur": 2e3, "args": {"correlation": 999}})
    path = tmp_path / "pass.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE_NS, "traceEvents": events}))
    recs = [{"id": i, "parent": parent, "name": name, "unit": 0, "kind": kind,
             "start_ns": BASE_NS + int(a * 1e6), "end_ns": BASE_NS + int(b * 1e6), "attrs": {}}
            for i, (name, kind, a, b, parent) in enumerate(span_rows)]
    return spans.load(str(path), units, (BASE_NS, BASE_NS + int(100e6)), recs)


@pytest.mark.parametrize("units", [1, 2])
@pytest.mark.parametrize("metric", sorted(TRAIN_WANT))
def test_each_train_reading_of_the_hand_built_trace_is_exact(tmp_path, metric, units):
    p = _hand_built(tmp_path, TRAIN_SPANS, TRAIN_DEVICE, units=units)
    assert spans.readings(p, "train")[metric] == pytest.approx(TRAIN_WANT[metric] / units,
                                                               abs=1e-9)


@pytest.mark.parametrize("metric", sorted(SCORE_WANT))
def test_each_score_reading_of_the_hand_built_trace_is_exact(tmp_path, metric):
    p = _hand_built(tmp_path, SCORE_SPANS, SCORE_DEVICE)
    assert spans.readings(p, "score")[metric] == pytest.approx(SCORE_WANT[metric], abs=1e-9)


def test_the_hand_built_pass_stages_and_clock_check(tmp_path):
    p = _hand_built(tmp_path, TRAIN_SPANS, TRAIN_DEVICE)
    st = spans.stages(p)
    assert st["train.step"]["host_self"] == pytest.approx(96 - 18 - 30 - 30 - 15)
    assert st["train.rows"]["host_self"] == pytest.approx(8.0)
    assert st["train.rows"]["device"] == pytest.approx(2.0)
    assert st["train.rows.to_device"]["idle"] == pytest.approx(6.0)
    assert st["train.optimizer"]["idle"] == pytest.approx(15.0)
    kernels = harness.load_kernels(REPO)
    assert spans.by_class(p, kernels) == {
        "train.rows": {"matmul": 0.0, "attention": 0.0, "other": 2.0},  # the gather
        "train.rows.to_device": {"matmul": 0.0, "attention": 0.0, "other": 2.0},  # the copy
        "train.forward": {"matmul": 22.0, "attention": 0.0, "other": 4.0},
        "train.backward": {"matmul": 20.0, "attention": 0.0, "other": 0.0},
        "train.optimizer": {"matmul": 0.0, "attention": 0.0, "other": 5.0}}
    check = spans.clock_check(p, "train")
    assert check["attributed_share"] == pytest.approx(1.0)
    assert check["launch_to_start_us_min"] == pytest.approx(0.0)  # gemm_a, the backward, sqrt
    assert check["end_past_window_us"] == pytest.approx(-10e3)  # sqrt ends at 90 of 100
    assert check["::sqrt_kernel in train.optimizer"] == [1, 1, {"0": 1}]
    assert check["copies"] == {"HtoD under train.rows.to_device": 1}
    score = spans.clock_check(_hand_built(tmp_path, SCORE_SPANS, SCORE_DEVICE), "score")
    assert score["copies"] == {"HtoD under score.rows.to_device": 1, "DtoH under score.to_host": 1}
    assert score["Memcpy DtoH in score.to_host"] == [1, 1, {"0": 1}]


def test_nothing_is_read_on_a_cpu_run_or_without_launch_events(tmp_path):
    p = _hand_built(tmp_path, TRAIN_SPANS, TRAIN_DEVICE)
    cpu = dataclasses.replace(p, on_device=False)
    bare = dataclasses.replace(p, launches={})
    for q in (cpu, bare, None):
        assert set(spans.readings(q, "train").values()) == {None}
        assert set(spans.readings(q, "score").values()) == {None}


def test_a_program_without_spans_gives_no_pass(monkeypatch):
    """The parent of the spans: its profile module has no ``recording``."""
    monkeypatch.setitem(sys.modules, "tst_torch.aux.profile", types.ModuleType("old_profile"))
    assert spans.run_pass(None, 1) is None


@pytest.mark.parametrize("cell,names", [
    ("tiny.tiny-train", [name for name, _, _ in TRAIN_TREE]),
    ("tiny.tiny-score", ["score.call", "score.rows", "score.rows.to_device", "score.chunk",
                         "score.to_host", "score.probs"])])
def test_the_probe_runs_a_tiny_cell_on_the_cpu(tmp_path, cell, names):
    """Set-up, the traced window and the spans pass on one session: a line
    a stage, the pass's wall beside the window's; no device reading on the
    CPU, and no span left kept."""
    err = io.StringIO()
    got = spans.probe(cell, 2718281828123, torch.device("cpu"), tiny.make_root(tmp_path), err)
    lines = err.getvalue().splitlines()
    assert [line.split()[1] for line in lines if line.startswith("stage ")] == names
    assert any(line.startswith("spans pass: ") for line in lines)
    assert got["units"] == (2 if cell.endswith("train") else 1)
    assert got["pass_ms_per_unit"] > 0 and got["window_ms_per_unit"] > 0
    assert set(got["readings"].values()) == {None} and got["clock"] is None
    assert profile.take() == []
