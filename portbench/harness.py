"""The cells of ``BENCHMARK.json`` run against the port, ``tst_torch``.

A cell is a configuration (``portbench/configs/<config>.json``) under a
traffic mix (``portbench/traffic/<traffic>.json``); its limits are in
``portbench/checks/<cell>.json``, its per-layer metrics' readers in
``portbench/metrics/<metric>.py`` and its kernels' names and counts in
``portbench/kernels/<kernel>.json``. All are found by name.

A mix of ``"kind": "train"`` drives ``FoldTrainer.step`` (the fold-parallel
LoRA step); ``"kind": "score"`` drives ``score_heldout_mcq`` (held-out MCQ
scoring through the fold adapters). A session makes the inputs from the
seed, builds the program's objects, runs the checked first steps (set-up),
then the timed or the traced window, then frees the program's state and
works out the reference's numbers for the comparison.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import os
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from portbench import compare, data, flops, trace as trace_mod
from portbench.reference import qwen2 as reference

ROOT = Path(__file__).resolve().parent.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    root: Path

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _read(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics: List[Dict[str, Any]], cell: str) -> List[Dict[str, Any]]:
    return [m for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _read(root / configs[w["config"]]["file"])
    traffic = _read(root / "portbench" / "traffic" / f"{w['traffic']}.json")
    return Cell(name, config, traffic, _for_cell(bench["end_to_end"], name),
                _for_cell(bench["per_layer"], name), root)


def load_reader(root: Path, metric: str) -> Callable:
    """``read(ctx)`` of ``portbench/metrics/<metric>.py``."""
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_kernels(root: Path) -> Dict[str, Dict[str, Any]]:
    return {p.stem: _read(p) for p in sorted((root / "portbench" / "kernels").glob("*.json"))}


def counter(path: str) -> int:
    """The value of a program counter named ``module.ATTRIBUTE``."""
    mod, _, attr = path.rpartition(".")
    return int(getattr(importlib.import_module(mod), attr))


# -- the program's objects -----------------------------------------------------------


def model_spec(cfg: Mapping):
    from tst_torch.models.spec import ModelSpec

    w = flops.widths(cfg)
    return ModelSpec(name=cfg["name"], vocab_size=w["V"], d_model=w["d"], n_layers=w["L"],
                     n_heads=w["H"], n_kv_heads=w["KVH"], d_head=w["dh"], d_ff=w["f"],
                     rope_theta=float(cfg["rope_theta"]), rms_eps=float(cfg["rms_norm_eps"]),
                     qkv_bias=data.qkv_bias(cfg),
                     tie_embeddings=bool(cfg.get("tie_word_embeddings", False)),
                     max_seq_len=int(cfg.get("max_position_embeddings", 32768)),
                     dtype=data.torch_dtype(cfg))


def lora_spec(cfg: Mapping, traffic: Mapping):
    from tst_torch.models.lora import LoraSpec

    lo = traffic["lora"]
    return LoraSpec(rank=int(lo["rank"]), alpha=float(lo["alpha"]),
                    targets=tuple(lo["targets"]), dtype=data.torch_dtype(cfg))


def fold_tree(tree: Mapping, f: int, dtype=torch.float32) -> Dict:
    """Fold ``f`` of a fold-stacked adapter tree, in ``dtype``."""
    return {p: {n: t[f].to(dtype) for n, t in ab.items()} for p, ab in tree.items()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Stamps:
    """The end of each unit of work on the run's clock: CUDA events on the
    card (read once the window has closed, so the loop never waits for the
    card), the host's clock after a synchronize elsewhere."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.marks: List[Any] = []

    def start(self) -> None:
        sync(self.device)
        self.t0 = time.perf_counter()
        if self.cuda:
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()

    def mark(self) -> None:
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def host_elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def seconds(self) -> List[float]:
        """Seconds from the start to each mark (the card synchronized)."""
        sync(self.device)
        if self.cuda:
            return [self.e0.elapsed_time(e) / 1e3 for e in self.marks]
        return [t - self.t0 for t in self.marks]


# -- sessions ----------------------------------------------------------------------------


class Session:
    """One run of a cell on one seed: inputs, the program, the reference."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        from tst_torch.runtime.device import select_device

        select_device(device.type if device.type == "cpu" else "gpu")
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg, self.traffic = cell.config, cell.traffic
        self.weights = data.make_weights(self.cfg, seed, device)
        self.spec = model_spec(self.cfg)
        self.lspec = lora_spec(self.cfg, self.traffic)

    def reference_model(self, quant: Optional[str] = None):
        return reference.Qwen2Reference(self.cfg, self.weights, self.traffic["lora"], quant=quant)


class TrainSession(Session):
    """``FoldTrainer.step`` on k·B rows a step."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        from tst_torch.train.sft import FoldTrainer

        t = self.traffic
        self.k, self.b = int(t["folds"]), int(t["rows_per_fold"])
        self.rows = data.make_rows(self.cfg, t, self.k * int(t["pool_rows_per_fold"]), seed,
                                   device)
        self.n_check = int(t["check_steps"])
        self.lora0 = data.make_adapters(self.cfg, t["lora"], self.k, seed, device)
        o = t["optim"]
        remat = bool(t.get("remat")) or bool(self.cfg.get("train_remat"))
        self.trainer = FoldTrainer(self.spec, self.lspec, self.k, lr=float(o["lr"]),
                                   total_steps=int(o["total_steps"]),
                                   warmup_frac=float(o["warmup_frac"]),
                                   weight_decay=float(o["weight_decay"]), use_pallas=True,
                                   remat=remat, t_max=int(t["t_max"]), b1=float(o["b1"]),
                                   b2=float(o["b2"]))
        self.lora = data.clone_tree(self.lora0)
        self.opt = self.trainer.tx.init(self.lora)
        self.batches = data.train_batches(t, 4096, seed)
        self.t = 0

    def samples_per_unit(self) -> int:
        return self.k * self.b

    def step(self):
        """The window's own call: one step on the next batch of the order."""
        r = self.rows
        self.lora, self.opt, loss = self.trainer.step(
            self.weights, self.lora, self.opt, r.tokens, r.loss_mask, r.answer_pos,
            self.batches[self.t % len(self.batches)])
        self.t += 1
        return loss

    def check_steps(self) -> None:
        """The first ``check_steps`` steps, kept for the comparison: the
        losses, the first moment after one step, the adapters after all."""
        b1 = float(self.traffic["optim"]["b1"])
        losses = []
        for i in range(self.n_check):
            losses.append(self.step())
            if i == 0:
                g1 = [fold_tree(self.opt.mu, f) for f in range(self.k)]
                self.got_grad1 = [{p: {n: t / (1 - b1) for n, t in ab.items()}
                                   for p, ab in tree.items()} for tree in g1]
        self.got_losses = losses
        self.got_delta = [
            {p: {n: self.lora[p][n][f].float() - self.lora0[p][n][f].float() for n in ab}
             for p, ab in self.lora0.items()} for f in range(self.k)]

    def got(self) -> Dict[str, Any]:
        return {"losses": [l.float().cpu().tolist() for l in self.got_losses],
                "grad1": self.got_grad1, "delta": self.got_delta}

    def free_program(self) -> None:
        self.lora = self.opt = self.trainer = None
        free(self.device)

    def reference_batches(self) -> List[List]:
        r = self.rows
        out = []
        for t in range(self.n_check):
            step = []
            for f in range(self.k):
                idx = torch.as_tensor(self.batches[t, f], device=self.device)
                step.append((r.tokens[idx], r.loss_mask[idx], r.answer_pos[idx]))
            out.append(step)
        return out

    def reference(self, quant: Optional[str] = None, fault: Optional[str] = None) -> Dict:
        """The reference's first steps (``quant="fp8"``: the control;
        ``fault``: "half" takes each fold's first half of the rows, "token"
        alters the first target token of each fold's first row)."""
        ref = self.reference_model(quant)
        batches = self.reference_batches()
        if fault == "token":
            v = int(self.cfg["vocab_size"])
            for step in batches:
                for f, (tok, mask, pos) in enumerate(step):
                    tok = tok.clone()
                    p0 = int(pos[0]) + 1
                    tok[0, p0] = (tok[0, p0] + 1) % v
                    step[f] = (tok, mask, pos)
        elif fault == "half":
            batches = [[(tok[: len(tok) // 2], mask[: len(tok) // 2], pos[: len(tok) // 2])
                        for tok, mask, pos in step] for step in batches]
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        adapters = [fold_tree(self.lora0, f) for f in range(self.k)]
        return reference.train_steps(ref, batches, int(self.traffic["t_max"]), adapters,
                                     self.traffic["optim"],
                                     int(self.traffic["reference_row_block"]))

    def gaps(self, ref: Mapping) -> Dict[str, float]:
        return compare.train_gaps(self.got(), ref)

    def model_flops(self) -> float:
        return flops.train_step_flops(self.cfg, self.traffic)

    def attention_shape(self):
        return self.k * self.b, int(self.traffic["seq_len"])


class ScoreSession(Session):
    """``score_heldout_mcq`` over ``rows_per_call`` held-out rows a call."""

    def __init__(self, cell: Cell, seed: int, device: torch.device):
        super().__init__(cell, seed, device)
        t = self.traffic
        self.k = int(t["folds"])
        self.n_call = int(t["rows_per_call"])
        self.n_pool = int(t["pool_calls"])
        self.rows = data.make_rows(self.cfg, t, self.n_call * self.n_pool, seed, device)
        self.lora = data.make_adapters(self.cfg, t["lora"], self.k, seed, device)
        #: (rows, probabilities) of every call, and of the window's calls
        self.history: List[tuple] = []
        self.calls: List[tuple] = []
        self.c = 0

    def samples_per_unit(self) -> int:
        return self.n_call

    def call_rows(self, c: int) -> slice:
        p = c % self.n_pool
        return slice(p * self.n_call, (p + 1) * self.n_call)

    def step(self) -> np.ndarray:
        from tst_torch.train.infer import score_heldout_mcq

        r, sl = self.rows, self.call_rows(self.c)
        probs = score_heldout_mcq(self.weights, self.lora, self.spec, self.lspec, r.tokens[sl],
                                  r.answer_pos[sl], r.option_ids, r.n_options[sl],
                                  r.fold_id[sl], self.k, use_pallas=True)
        self.history.append((sl, probs))
        self.c += 1
        return probs

    def check_steps(self) -> None:
        self.step()  # the first call builds and warms up; not compared

    def free_program(self) -> None:
        free(self.device)

    def sample(self) -> np.ndarray:
        """The pool rows compared: drawn from the seed among those the
        window scored."""
        if not self.calls:
            return np.zeros(0, np.int64)
        scored = np.unique(np.concatenate([np.arange(sl.start, sl.stop) for sl, _ in self.calls]))
        return scored[data.sample(len(scored), int(self.traffic["check_rows"]), self.seed)]

    def got_for(self, rows: np.ndarray) -> List[np.ndarray]:
        """Every probability vector the window gave each of ``rows``."""
        return [np.stack([probs[row - sl.start] for sl, probs in self.calls
                          if sl.start <= row < sl.stop]) for row in rows]

    def reference_probs(self, rows: np.ndarray, quant: Optional[str] = None) -> np.ndarray:
        ref = self.reference_model(quant)
        r = self.rows
        out = np.zeros((len(rows), int(self.traffic["letters"])), np.float64)
        block = int(self.traffic["reference_row_block"])
        for f in range(self.k):
            mine = np.flatnonzero(r.fold_id[rows] == f)
            adapter = fold_tree(self.lora, f)
            for i in range(0, len(mine), block):
                sel = mine[i: i + block]
                idx = torch.as_tensor(rows[sel], device=self.device)
                p = ref.letter_probs(r.tokens[idx], r.answer_pos[idx], r.option_ids,
                                     r.n_options[rows[sel]], adapter)
                out[sel] = p.double().cpu().numpy()
        return out

    def gaps_against(self, rows: np.ndarray, want: np.ndarray) -> Dict[str, float]:
        return {"prob": compare.prob_gap(self.got_for(rows), want)}

    def model_flops(self) -> float:
        return flops.score_call_flops(self.cfg, self.traffic)

    def attention_shape(self):
        from tst_torch.train.infer import scorer_batch

        s = int(self.traffic["seq_len"])
        return scorer_batch(s), s


SESSIONS = {"train": TrainSession, "score": ScoreSession}


def session(cell: Cell, seed: int, device: torch.device) -> Session:
    return SESSIONS[cell.kind](cell, seed, device)


# -- windows -----------------------------------------------------------------------------


def timed_window(sess: Session, seconds: float) -> Dict[str, Any]:
    """Units of work back to back for ``seconds``: those that ended inside
    the window, their rate over the time from the window's start to the last
    one's end, and each one's time."""
    st = Stamps(sess.device)
    st.start()
    first = len(getattr(sess, "history", []))
    outs = []
    while True:
        outs.append(sess.step())
        st.mark()
        if st.host_elapsed() >= seconds:
            break
    ends = st.seconds()
    done = [i for i, e in enumerate(ends) if e <= seconds] or [0]
    last = ends[done[-1]]
    steps = np.diff([0.0] + ends)[done]
    if isinstance(sess, ScoreSession):
        sess.calls = [sess.history[first + i] for i in done]
    bad = sum(1 for i in done if not _finite(outs[i]))
    return {"units": len(done), "rate": len(done) * sess.samples_per_unit() / last,
            "unit_s": steps.tolist(), "failed": bad, "window_end_s": last}


def _finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x).all())
    return bool(np.isfinite(np.asarray(x)).all())


@dataclasses.dataclass
class TraceContext:
    """What a per-layer metric's reader reads: the cell, the traced window
    (``trace``, ``units`` of work in it), the model FLOPs of a unit, the
    program's launch counts over the window, the kernels' files and the
    attention calls' shape (rows a call, tokens a row)."""

    cell: Cell
    trace: trace_mod.Trace
    units: int
    model_flops: float
    launches: Dict[str, Dict[str, int]]
    kernels: Dict[str, Dict[str, Any]]
    attention_rows: int
    seq_len: int

    @property
    def kind(self) -> str:
        return self.cell.kind


def traced_window(sess: Session, units: int) -> Tuple[TraceContext, trace_mod.Trace]:
    """``units`` of work traced with the card's activity alone (the
    metrics), then one more under the program's own trace, host operations
    included (the idle gaps by host operation); both traces read back and
    deleted."""
    from torch.profiler import ProfilerActivity, profile

    from tst_torch.aux.profile import TRACE_FILE, trace as profile_trace

    kernels = load_kernels(sess.cell.root)

    def counts():
        return {k: {n: counter(p) for n, p in spec.get("launch_counters", {}).items()}
                for k, spec in kernels.items()}

    first = len(getattr(sess, "history", []))
    cuda = sess.device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        sync(sess.device)
        before = counts()
        prof = profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU])
        prof.start()
        sync(sess.device)
        t0 = time.perf_counter()
        for _ in range(units):
            sess.step()
        sync(sess.device)
        window_s = time.perf_counter() - t0
        prof.stop()
        after = counts()
        path = os.path.join(tmp, "window.json")
        prof.export_chrome_trace(path)
        tr = trace_mod.load_device(path, window_s)
        host_dir = os.path.join(tmp, "host")
        with profile_trace(host_dir):
            with torch.profiler.record_function(trace_mod.WINDOW):
                sess.step()
                sync(sess.device)
        host = trace_mod.load_annotated(os.path.join(host_dir, TRACE_FILE))
    if isinstance(sess, ScoreSession):
        sess.calls = sess.history[first:]
    launches = {k: {n: after[k][n] - before[k][n] for n in after[k]} for k in after}
    rows, s = sess.attention_shape()
    ctx = TraceContext(sess.cell, tr, units, sess.model_flops(), launches, kernels, rows, s)
    return ctx, host


def read_per_layer(ctx: TraceContext) -> Dict[str, Dict[str, Any]]:
    out = {}
    for m in ctx.cell.per_layer:
        value = load_reader(ctx.cell.root, m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def breakdown(tr: trace_mod.Trace, host: trace_mod.Trace) -> Dict[str, List]:
    """The device operations that took most time in the metrics' window, and
    the longest idle gaps of the unit traced with the host's operations."""
    return {"device_ops": trace_mod.top_device_ops(tr), "idle_gaps": trace_mod.idle_gaps(host)}


# -- the comparison ----------------------------------------------------------------------


def check(sess: Session) -> Dict[str, float]:
    """The numbers compared, once the program's state is freed."""
    if isinstance(sess, TrainSession):
        sess.free_program()
        return sess.gaps(sess.reference())
    sess.free_program()
    rows = sess.sample()
    if len(rows) == 0:
        return {"prob": math.inf}
    return sess.gaps_against(rows, sess.reference_probs(rows))
