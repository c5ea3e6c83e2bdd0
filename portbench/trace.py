"""Reading the profiler's Chrome traces of a traced run.

The metrics' window is traced with device activity alone, so that the
profiler does not slow the host: its device events (kernels, copies, sets)
all fall between the synchronizes that bound it, and its length is the
host's clock between them. Their union is the time the card was busy.
One more unit of work is traced with the host's operations too, inside the
CPU annotation ``portbench.window``; the card's idle gaps there are named by
the innermost host operation running at each gap's start.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW = "portbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    window_s: float
    #: (name, start µs, duration µs) of every device event inside the window
    device: List[Tuple[str, float, float]]
    #: (name, start µs, duration µs, thread) of the host operations
    host: List[Tuple[str, float, float, int]] = dataclasses.field(default_factory=list)
    #: the window's bounds on the trace's clock, where an annotation gives them
    window_us: Optional[Tuple[float, float]] = None


def _events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def load_device(path: str, window_s: float) -> Trace:
    """Every device event of a trace taken between two synchronizes
    ``window_s`` seconds apart."""
    device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0))) for e in _events(path)
              if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    return Trace(window_s, sorted(device, key=lambda ev: ev[1]))


def load_annotated(path: str) -> Trace:
    """The device events and host operations inside the ``portbench.window``
    annotation of a trace."""
    events = _events(path)
    wins = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
            and e.get("cat") == "user_annotation"]
    if not wins:
        raise ValueError(f"{path}: no {WINDOW!r} annotation")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if e.get("cat") in _DEVICE_CATS:
            a, b = max(ts, w0), min(ts + dur, w1)
            if b > a:
                device.append((e["name"], a, b - a))
        elif e.get("cat") == "cpu_op" and ts < w1 and ts + dur > w0:
            host.append((e["name"], ts, dur, int(e.get("tid", 0))))
    device.sort(key=lambda ev: ev[1])
    return Trace((w1 - w0) / 1e6, device, host, (w0, w1))


def busy_intervals(tr: Trace) -> List[Tuple[float, float]]:
    """The union of the device events as sorted disjoint [start, end) µs."""
    out: List[List[float]] = []
    for _, ts, dur in tr.device:
        if out and ts <= out[-1][1]:
            out[-1][1] = max(out[-1][1], ts + dur)
        else:
            out.append([ts, ts + dur])
    return [(a, b) for a, b in out]


def busy_s(tr: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(tr)) / 1e6


def matches(name: str, patterns: Sequence[str]) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in patterns)


def device_seconds(tr: Trace, patterns: Sequence[str] = (), exclude: Sequence[str] = ()) -> float:
    """Device seconds of the events whose name holds one of ``patterns``
    (every event when none) and none of ``exclude``."""
    return sum(dur for name, _, dur in tr.device
               if (not patterns or matches(name, patterns))
               and not (exclude and matches(name, exclude))) / 1e6


def _short(name: str, width: int = 120) -> str:
    name = re.sub(r"\s+", " ", name)
    return name if len(name) <= width else name[: width - 3] + "..."


def top_device_ops(tr: Trace, n: int = 10) -> List[List]:
    """[[name, seconds]] of the ``n`` device operations that took most time."""
    acc: Dict[str, float] = {}
    for name, _, dur in tr.device:
        acc[name] = acc.get(name, 0.0) + dur / 1e6
    rows = sorted(acc.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[_short(k), v] for k, v in rows]


def idle_gaps(tr: Trace, n: int = 10) -> List[List]:
    """[[host operation, seconds]]: the card's idle gaps inside the window,
    summed by the innermost host operation running where each gap starts
    (``python`` where no operator runs: the interpreter between them), the
    ``n`` largest."""
    busy = busy_intervals(tr)
    edges = [tr.window_us[0]] + [x for ab in busy for x in ab] + [tr.window_us[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    host = sorted(tr.host, key=lambda ev: ev[1])
    starts = [ev[1] for ev in host]
    acc: Dict[str, float] = {}
    for a, b in gaps:
        inner, best = "python", None
        hi = bisect.bisect_right(starts, a)
        for name, ts, dur, _ in host[max(0, hi - 2000): hi]:
            if ts <= a < ts + dur and (best is None or dur < best):
                inner, best = name, dur
        acc[inner] = acc.get(inner, 0.0) + (b - a) / 1e6
    rows = sorted(acc.items(), key=lambda kv: kv[1], reverse=True)[:n]
    return [[_short(k), v] for k, v in rows]
