"""Tracing and stage spans (counterpart of ``tst/aux/profile.py``).

``trace`` records a block with ``torch.profiler`` (CPU and, where there is a
card, CUDA activities) and writes a Chrome trace and ``op_summary.json``,
the top device ops (the kernels; CPU ops on a CPU run) by total time,
summed by name over the trace's events. The reference reads its summary out
of an XProf trace through ``tst/aux/xplane.py``, which has no counterpart
here: the profiler writes the trace itself. The summary is read from the
exported trace and not from ``key_averages()``, which rebuilds every event
in Python: 13 s for 60,000 CPU ops against 0.6 s for the export, on one
core of an x86 host. The reference's ``cost_analysis`` reads XLA's
compiled cost, which eager torch does not have.

``span`` marks a stage of the program (the train step's rows, forward,
backward and optimizer; the scorer's rows, chunks, copy to the host and
probabilities). Spans are kept only inside ``recording()``, in memory, and
``take()`` hands them over: outside it, and outside ``trace``, a span
tests two flags and returns a shared object that does nothing (no clock
read, no allocation, no CUDA event, no ``record_function``). A recorded span has an ``id``, its
``parent`` (the innermost span open when it opened), a ``name``, a
``unit`` (the step or call it belongs to, inherited from the parent), a
``kind`` (``work``, or ``wait`` where the host waits for the card), its
start and end on the wall clock in ns (``time.time_ns``'s clock, which is
the clock of a profiler trace's ``baseTimeNanoseconds``) and ``attrs``
(rows, bytes). Under ``trace`` a span opens
``torch.profiler.record_function``, kept or not, so the stages show as bars
in the trace.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

TRACE_FILE = "trace.json"
SUMMARY_FILE = "op_summary.json"


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """``with trace("/tmp/prof"):`` profiles the block into ``profile_dir``
    (``trace.json``, ``op_summary.json``); a no-op for None."""
    global _HOST_PROFILE
    if not profile_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    _HOST_PROFILE = True
    try:
        yield prof
    finally:
        _HOST_PROFILE = False
        if ProfilerActivity.CUDA in activities:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
        write_op_summary(profile_dir, device=ProfilerActivity.CUDA in activities)


#: the trace's event categories that are device work
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def op_summary(trace_path: str, device: bool, top: int = 60) -> List[Dict[str, Any]]:
    """The ``top`` ops of a Chrome trace by total time: its device events
    (kernels, copies, sets) with ``device``, else its CPU ops, summed by
    name → name, calls, total microseconds."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    cats = _DEVICE_CATS if device else ("cpu_op",)
    totals: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in cats:
            acc = totals.setdefault(ev["name"], [0, 0.0])
            acc[0] += 1
            acc[1] += float(ev.get("dur", 0.0))
    rows = [{"name": name, "calls": n, "total_us": us} for name, (n, us) in totals.items()]
    rows.sort(key=lambda r: r["total_us"], reverse=True)
    return rows[:top]


def write_op_summary(profile_dir: str, device: bool, top: int = 60) -> str:
    """``op_summary.json`` beside the trace → its path."""
    trace_path = os.path.join(profile_dir, TRACE_FILE)
    out = os.path.join(profile_dir, SUMMARY_FILE)
    with open(out, "w") as f:
        json.dump({"trace": trace_path, "time": "device" if device else "cpu",
                   "top_ops": op_summary(trace_path, device, top)}, f, indent=1)
    return out


# -- stage spans --------------------------------------------------------------

#: spans are kept (``recording()`` is open)
_ON = False
#: ``trace`` is profiling the host: a span opens ``record_function``
_HOST_PROFILE = False
_SPANS: List[Dict[str, Any]] = []
#: the open spans' records, innermost last
_OPEN: List[Dict[str, Any]] = []
_IDS = itertools.count()
#: wall-clock ns less ``perf_counter`` ns, taken when ``recording()`` opened
_OFFSET_NS = 0


class _Off:
    """The span of a stage while nothing is kept."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "fn")

    def __init__(self, name: str, unit, kind: str, attrs: Dict[str, Any]):
        parent = _OPEN[-1] if _OPEN else None
        if unit is None and parent is not None:
            unit = parent["unit"]
        self.rec = {"id": next(_IDS), "parent": None if parent is None else parent["id"],
                    "name": name, "unit": unit, "kind": kind, "start_ns": 0, "end_ns": 0,
                    "attrs": attrs}
        self.fn = None

    def __enter__(self):
        rec = self.rec
        _SPANS.append(rec)
        _OPEN.append(rec)
        rec["start_ns"] = time.perf_counter_ns()
        if _HOST_PROFILE:
            self.fn = torch.profiler.record_function(rec["name"])
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        self.rec["end_ns"] = time.perf_counter_ns()
        _OPEN.pop()
        return False


def span(name: str, unit=None, kind: str = "work", **attrs):
    """``with span("train.forward"):`` marks a stage; kept only inside
    :func:`recording`, a bar of the trace inside :func:`trace`. ``unit``: the step or call (children inherit their
    parent's); ``kind``: ``"work"``, or ``"wait"`` where the host waits for
    the card (a copy from pageable memory, a copy to the host)."""
    if _ON:
        return _Span(name, unit, kind, attrs)
    if _HOST_PROFILE:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """Keeps the spans of the block (those kept before and not taken are
    dropped); :func:`take` hands them over."""
    global _ON, _OFFSET_NS, _IDS
    _SPANS.clear()
    _OPEN.clear()
    _IDS = itertools.count()
    _OFFSET_NS = time.time_ns() - time.perf_counter_ns()
    _ON = True
    try:
        yield
    finally:
        _ON = False


def take() -> List[Dict[str, Any]]:
    """The spans kept so far (in the order they opened, times on the wall
    clock in ns; a span still open has no end yet), and none kept after."""
    out = [dict(rec, start_ns=rec["start_ns"] + _OFFSET_NS,
                end_ns=rec["end_ns"] + _OFFSET_NS if rec["end_ns"] else None) for rec in _SPANS]
    _SPANS.clear()
    return out
