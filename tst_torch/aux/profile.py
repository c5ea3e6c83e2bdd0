"""Tracing and step timing (counterpart of ``tst/aux/profile.py``).

``trace`` records a block with ``torch.profiler`` (CPU and, where there is a
card, CUDA activities) and writes a Chrome trace and ``op_summary.json``,
the top device ops (the kernels; CPU ops on a CPU run) by total time,
summed by name over the trace's events. The reference reads its summary out
of an XProf trace through ``tst/aux/xplane.py``, which has no counterpart
here: the profiler writes the trace itself. The summary is read from the
exported trace and not from ``key_averages()``, which rebuilds every event
in Python: 13 s for 60,000 CPU ops against 0.6 s for the export, on one
core of an x86 host. ``StepTimer`` synchronizes the
card before it reads the clock. The reference's ``cost_analysis`` reads
XLA's compiled cost, which eager torch does not have; the step's FLOPs
come from ``tst_torch.aux.flops``.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

TRACE_FILE = "trace.json"
SUMMARY_FILE = "op_summary.json"


@contextlib.contextmanager
def trace(profile_dir: Optional[str]):
    """``with trace("/tmp/prof"):`` profiles the block into ``profile_dir``
    (``trace.json``, ``op_summary.json``); a no-op for None."""
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
    try:
        yield prof
    finally:
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


class StepTimer:
    """Per-step wall timing with warmup discard; a hard sync on demand (a
    CUDA tensor synchronizes its card, anything else is read to the host)."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._times: List[float] = []
        self._t0: Optional[float] = None
        self._n = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_value=None):
        if isinstance(sync_value, torch.Tensor) and sync_value.device.type == "cuda":
            torch.cuda.synchronize(sync_value.device)
        elif sync_value is not None:
            np.asarray(sync_value)  # force host materialization
        dt = time.perf_counter() - self._t0
        self._n += 1
        if self._n > self.warmup:
            self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self._times) if self._times else np.asarray([float("nan")])
        return {
            "steps_timed": len(self._times),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
        }
