"""The program's stage spans (``tst_torch.aux.profile.span``) put on the
device trace's clock, and the card's time attributed to them.

    python3 -m portbench.spans --workload <cell> --seed <n>

from the root of a checkout, on a machine with an NVIDIA card: the cell's
set-up and traced window as ``python3 -m portbench.run --trace 1`` runs
them (spans off), then the spans pass on the same session: ``trace_steps``
(``trace_calls``) more units inside ``recording()``, under a profile of the
card's activity alone as the window is traced. Standard error gets one line
a stage, the pass's wall a unit beside the window's, the idle by kind and
the clock check; the last line of standard output is one JSON object with
the stage readings (:func:`readings`). This is not a cell's run: no metric
of ``BENCHMARK.json`` reads it, and it makes no comparison.

Attribution. A device event (kernel, copy, set) belongs to the innermost
span open on the host when its launch was issued: the ``cuda_runtime`` or
``cuda_driver`` event with the same ``correlation``. By time, not by
thread: autograd launches the backward's kernels from its own thread while
the main thread waits inside ``train.backward``. Never by the event's own
time: the host runs ahead of the card (~120 ms at 7B), and the card's
timestamps need not agree with the host's clock to the µs. For the same
reason the pass keeps the events whose launch lies inside it, not those
that ran inside it. An idle gap of the card goes to the innermost span open
on the host where the gap starts: under a ``wait`` span it is waiting,
under another span dispatch idle (the card waits for the host), outside
every span the caller's own.

A span's wall-clock ns become the trace's µs through the trace's
``baseTimeNanoseconds``. Nothing is read on a CPU run, from a program
without spans (``None``), or without launch events.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from portbench import trace as trace_mod

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: (span, device events by name that only that span issues: AdamW's
#: square roots, the scores' copy to the host), whose launches must all lie
#: inside it: a check of the clocks that owes nothing to the attribution
PROBES = {"train": (("train.optimizer", "::sqrt_kernel"),),
          "score": (("score.to_host", "Memcpy DtoH"),)}


@dataclasses.dataclass
class Pass:
    """What the pass recorded, on the trace's clock (µs)."""

    units: int
    window_us: Tuple[float, float]
    #: (name, start, duration, correlation) of every device event
    device: List[Tuple[str, float, float, Optional[int]]]
    #: correlation → host start of the launch
    launches: Dict[int, float]
    #: the program's spans: ``take()``'s records with ``start_us``, ``end_us``
    spans: List[Dict[str, Any]]
    on_device: bool = True

    def __post_init__(self):
        self._segments = segments(self.spans)
        self._starts = [seg[0] for seg in self._segments]

    def at(self, t: float) -> Optional[Dict[str, Any]]:
        """The innermost span open on the host at ``t``."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self._segments[i][1]:
            return self._segments[i][2]
        return None


def segments(spans: Sequence[Dict[str, Any]]) -> List[Tuple[float, float, Dict[str, Any]]]:
    """Disjoint [start, end) µs pieces of the spans' union, each with the
    innermost span open over it (the latest to open; spans nest)."""
    edges = sorted({x for s in spans for x in (s["start_us"], s["end_us"])})
    out = []
    for a, b in zip(edges, edges[1:]):
        open_ = [s for s in spans if s["start_us"] <= a and b <= s["end_us"]]
        if open_:
            out.append((a, b, max(open_, key=lambda s: (s["start_us"], s["id"]))))
    return out


def union_us(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def busy(p: Pass) -> List[Tuple[float, float]]:
    """The union of the device events inside the window, as sorted
    disjoint intervals."""
    w0, w1 = p.window_us
    out: List[List[float]] = []
    for _, ts, dur, _ in sorted(p.device, key=lambda ev: ev[1]):
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(p: Pass) -> List[Tuple[float, float, Optional[Dict[str, Any]]]]:
    """The card's idle gaps inside the window, each with the innermost span
    open on the host where it starts."""
    edges = [p.window_us[0]] + [x for ab in busy(p) for x in ab] + [p.window_us[1]]
    return [(edges[i], edges[i + 1], p.at(edges[i])) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def attributed(p: Pass) -> Dict[Optional[str], List[Tuple[float, float]]]:
    """Span name → the device intervals launched under it (``None``: no
    span, or no launch event)."""
    out: Dict[Optional[str], List[Tuple[float, float]]] = {}
    for _, ts, dur, corr in p.device:
        t = p.launches.get(corr)
        s = None if t is None else p.at(t)
        out.setdefault(None if s is None else s["name"], []).append((ts, ts + dur))
    return out


def _readable(p: Optional[Pass]) -> bool:
    return p is not None and p.on_device and bool(p.spans) and bool(p.launches)


def device_ms(p: Optional[Pass], name: str) -> Optional[float]:
    """Device ms a unit launched under the spans named ``name`` (the union
    of their events)."""
    if not _readable(p):
        return None
    return union_us(attributed(p).get(name, [])) / 1e3 / p.units


def host_wait_ms(p: Optional[Pass]) -> Optional[float]:
    """Host ms a unit inside ``wait`` spans."""
    if not _readable(p):
        return None
    return union_us((s["start_us"], s["end_us"]) for s in p.spans
                    if s["kind"] == "wait") / 1e3 / p.units


def dispatch_idle_ms(p: Optional[Pass]) -> Optional[float]:
    """Idle ms a unit of the card whose gaps start under a span that is not
    a ``wait``."""
    if not _readable(p):
        return None
    return sum(b - a for a, b, s in gaps(p)
               if s is not None and s["kind"] != "wait") / 1e3 / p.units


def readings(p: Optional[Pass], kind: str) -> Dict[str, Optional[float]]:
    """The stage readings of a train step or a scorer call, in ms a unit
    (each ``None`` where nothing can be read)."""
    if kind == "train":
        return {"forward_ms_per_step": device_ms(p, "train.forward"),
                "backward_ms_per_step": device_ms(p, "train.backward"),
                "optimizer_ms_per_step": device_ms(p, "train.optimizer"),
                "host_wait_ms_per_step": host_wait_ms(p),
                "dispatch_idle_ms_per_step": dispatch_idle_ms(p)}
    return {"forward_ms_per_call": device_ms(p, "score.chunk"),
            "host_wait_ms_per_call": host_wait_ms(p),
            "dispatch_idle_ms_per_call": dispatch_idle_ms(p)}


def stages(p: Pass) -> Dict[str, Dict[str, Any]]:
    """Span name → ms a unit: host self time (the span less its children),
    device time launched under it, idle time of gaps that start under it."""
    kids: Dict[int, float] = {}
    for s in p.spans:
        if s["parent"] is not None:
            kids[s["parent"]] = kids.get(s["parent"], 0.0) + s["end_us"] - s["start_us"]
    out: Dict[str, Dict[str, Any]] = {}
    for s in p.spans:
        row = out.setdefault(s["name"], {"kind": s["kind"], "host_self": 0.0, "device": 0.0,
                                         "idle": 0.0})
        row["host_self"] += (s["end_us"] - s["start_us"] - kids.get(s["id"], 0.0)) / 1e3
    for name, iv in attributed(p).items():
        if name is not None:
            out[name]["device"] = union_us(iv) / 1e3
    for a, b, s in gaps(p):
        if s is not None:
            out[s["name"]]["idle"] += (b - a) / 1e3
    for row in out.values():
        for k in ("host_self", "device", "idle"):
            row[k] /= p.units
    return out


def by_class(p: Pass, kernels: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, float]]:
    """Span name → device ms a unit in the attention kernels, the GEMMs
    and the rest (the name patterns of ``portbench/kernels/*.json``, as
    the window's ``matmul_ms``, ``other_ms`` and ``attn_roofline`` read
    them), summed over the events launched under it."""
    attn, mm = kernels["attention"]["patterns"], kernels["matmul"]["patterns"]
    out: Dict[str, Dict[str, float]] = {}
    for name, _, dur, corr in p.device:
        s = p.at(p.launches[corr]) if corr in p.launches else None
        if s is None:
            continue
        cls = ("attention" if trace_mod.matches(name, attn) else
               "matmul" if trace_mod.matches(name, mm) else "other")
        row = out.setdefault(s["name"], {"matmul": 0.0, "attention": 0.0, "other": 0.0})
        row[cls] += dur / 1e3 / p.units
    return out


def clock_check(p: Pass, kind: str) -> Dict[str, Any]:
    """The share of the device time launched under the program's spans;
    the copies by direction and the span they were launched under; for
    each probe the device events of that name whose launch lies inside a
    span of that name, of all such events, and how many each unit's spans
    hold; and two readings of the clocks alone, in µs: the least time from
    a launch to its event's start (below 0, the card's clock reads earlier
    than the host's), and how far the last event ends past the window's
    closing read of the host's clock (above 0, later)."""
    att = attributed(p)
    total = union_us(iv for ivs in att.values() for iv in ivs)
    named = union_us(iv for name, ivs in att.items() if name is not None
                     and name.split(".")[0] == kind for iv in ivs)
    out: Dict[str, Any] = {"attributed_share": named / total if total else None}
    lags = [ts - p.launches[corr] for _, ts, _, corr in p.device if corr in p.launches]
    out["launch_to_start_us_min"] = min(lags) if lags else None
    out["end_past_window_us"] = (max(ts + dur for _, ts, dur, _ in p.device) - p.window_us[1]
                                 if p.device else None)
    copies: Dict[str, int] = {}
    for name, _, _, corr in p.device:
        if name.startswith("Memcpy "):
            s = p.at(p.launches[corr]) if corr in p.launches else None
            key = f"{name.split()[1]} under {s['name'] if s else None}"
            copies[key] = copies.get(key, 0) + 1
    out["copies"] = copies
    for span_name, pattern in PROBES.get(kind, ()):
        inside = [(s["start_us"], s["end_us"], s["unit"]) for s in p.spans
                  if s["name"] == span_name]
        hits, n, by_unit = 0, 0, {}
        for name, _, _, corr in p.device:
            if pattern in name and corr in p.launches:
                n += 1
                t = p.launches[corr]
                unit = next((u for a, b, u in inside if a <= t < b), None)
                hits += unit is not None
                by_unit[str(unit)] = by_unit.get(str(unit), 0) + 1
        out[f"{pattern} in {span_name}"] = [hits, n, by_unit]
    return out


def load(path: str, units: int, window_ns: Tuple[int, int],
         spans: Sequence[Dict[str, Any]]) -> Pass:
    """A pass from its exported trace, its window on the wall clock and the
    program's spans (``take()``): the device events launched inside the
    window, and those without a launch event that ran inside it."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    w0, w1 = ((t - base) / 1e3 for t in window_ns)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in _LAUNCH_CATS and corr is not None:
            launches[corr] = float(e["ts"])
    device = []
    for e in events:
        if e.get("cat") in _DEVICE_CATS:
            corr = (e.get("args") or {}).get("correlation")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            t = launches.get(corr)
            if (w0 <= t <= w1) if t is not None else (ts < w1 and ts + dur > w0):
                device.append((e["name"], ts, dur, corr))
    return Pass(units, (w0, w1), device, launches, on_trace_clock(spans, base))


def on_trace_clock(spans: Sequence[Dict[str, Any]], base_ns: int) -> List[Dict[str, Any]]:
    return [dict(s, start_us=(s["start_ns"] - base_ns) / 1e3,
                 end_us=(s["end_ns"] - base_ns) / 1e3) for s in spans if s["end_ns"]]


def run_pass(sess, units: int) -> Optional[Pass]:
    """``units`` more units of the session ``sess`` with the spans kept,
    under a profile of the card's activity alone (``None`` from a program
    without spans)."""
    try:
        from tst_torch.aux.profile import recording, take
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile

    from portbench import harness

    device = sess.device
    prof = profile(activities=[ProfilerActivity.CUDA]) if device.type == "cuda" else None
    with tempfile.TemporaryDirectory(prefix="portbench-spans-") as tmp:
        if prof is not None:
            prof.start()
        harness.sync(device)
        with recording():
            w0 = time.time_ns()
            for _ in range(units):
                sess.step()
            harness.sync(device)
            w1 = time.time_ns()
        spans = take()
        if prof is None:
            p = Pass(units, (w0 / 1e3, w1 / 1e3), [], {}, on_trace_clock(spans, 0), False)
        else:
            prof.stop()
            path = os.path.join(tmp, "spans.json")
            prof.export_chrome_trace(path)
            p = load(path, units, (w0, w1), spans)
    return p


def report(p: Pass, ctx, out=sys.stderr) -> None:
    """One line a stage (its device time also by kernel class), the pass's
    wall beside the traced window's (``ctx``, spans off), and on the card
    the idle by kind and the clock check, on ``out``."""
    unit = "step" if ctx.kind == "train" else "call"
    classes = by_class(p, ctx.kernels) if p.on_device else {}
    for name, row in stages(p).items():
        dev = f"{row['device']:.3f}" if p.on_device else "-"
        idle = f"{row['idle']:.3f}" if p.on_device else "-"
        split = ", ".join(f"{k} {v:.3f}" for k, v in classes.get(name, {}).items())
        print(f"stage {name} ({row['kind']}): host self {row['host_self']:.3f} ms, "
              f"device {dev} ms{f' ({split})' if split else ''}, idle {idle} ms a {unit}",
              file=out)
    wall = (p.window_us[1] - p.window_us[0]) / 1e3 / p.units
    window = 1e3 * ctx.trace.window_s / ctx.units
    print(f"spans pass: {p.units} {unit}s, {wall:.3f} ms a {unit} with spans on; the traced "
          f"window {window:.3f} ms a {unit} with spans off ({100 * (wall / window - 1):+.2f}%)",
          file=out)
    if p.on_device:
        idle = {"wait": 0.0, "dispatch": 0.0, "outside": 0.0}
        for a, b, s in gaps(p):
            key = "outside" if s is None else "wait" if s["kind"] == "wait" else "dispatch"
            idle[key] += (b - a) / 1e3 / p.units
        print(f"spans idle ms a {unit}: {json.dumps(idle)}; clock check: "
              f"{json.dumps(clock_check(p, ctx.kind))}", file=out)


def probe(workload: str, seed: int, device: torch.device, root=None, out=sys.stderr) -> dict:
    """The cell's set-up, its traced window, then the spans pass on the same
    session → the result object (``report`` on ``out``)."""
    from portbench import harness

    cell = harness.load_cell(workload, root or harness.ROOT)
    units = int(cell.traffic["trace_steps" if cell.kind == "train" else "trace_calls"])
    sess = harness.session(cell, seed, device)
    sess.check_steps()
    ctx, _ = harness.traced_window(sess, units)
    p = run_pass(sess, units)
    result = {"workload": workload, "seed": seed, "units": units,
              "window_ms_per_unit": 1e3 * ctx.trace.window_s / ctx.units,
              "pass_ms_per_unit": None, "readings": readings(p, cell.kind), "clock": None}
    if p is not None:
        report(p, ctx, out)
        result["pass_ms_per_unit"] = (p.window_us[1] - p.window_us[0]) / 1e3 / p.units
        result["clock"] = clock_check(p, cell.kind) if p.on_device else None
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from portbench import run

    run.cache_dirs(run.ROOT)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA card", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, torch.get_num_threads()))
    print(json.dumps(probe(args.workload, args.seed, torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
