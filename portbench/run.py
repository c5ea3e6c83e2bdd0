"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card. Makes the
cell's inputs and weights on the card from ``--seed``, builds the port's
objects (``tst_torch``), runs the checked first steps, then with
``--trace 0`` the timed window of ``--seconds`` (the cell's end-to-end
metrics) or with ``--trace 1`` a short profiled window (its per-layer
metrics, ``busy_s``, ``window_s`` and ``breakdown``). Then it frees the
program's state and compares what the program produced with the plain
reference (``portbench/reference``). The last line of standard output is
one JSON object; the numbers compared and their limits close both streams.

Exits 3 without a result when there is no CUDA card, and 4 when the JAX
package or JAX itself was loaded into this process.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: modules that may not be loaded, compared by their whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "tst")


def cache_dirs(root: Path) -> None:
    """Every compiler cache the program could use, at fixed paths inside
    the checkout (the kernel library builds into ``tst_torch/_build``)."""
    base = root / "portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(args, device=None, root: Path = ROOT, start: float = PROCESS_START) -> dict:
    """One run → the result object. ``device`` None takes the card (and
    raises SystemExit(3) without one); tests pass the CPU."""
    import numpy as np
    import torch

    from portbench import compare, harness

    cell = harness.load_cell(args.workload, root)
    chips = next(w for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]
                 if w["name"] == args.workload)["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s); "
                  f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
            raise SystemExit(3)
        device = torch.device("cuda", 0)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    t_import = time.perf_counter()
    sess = harness.session(cell, args.seed, device)
    harness.sync(device)
    t_build = time.perf_counter()
    sess.check_steps()
    harness.sync(device)
    setup_s = time.perf_counter() - start
    print(f"setup: {t_import - start:.2f} s to import, {t_build - t_import:.2f} s for the inputs "
          f"and the program's objects, {setup_s - (t_build - start):.2f} s for the checked "
          "first steps", file=sys.stderr)
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if args.trace:
        ctx, host = harness.traced_window(
            sess, int(cell.traffic["trace_steps" if cell.kind == "train" else "trace_calls"]))
        result["attempted"] = ctx.units
        result["metrics"] = harness.read_per_layer(ctx)
        busy = harness.trace_mod.busy_s(ctx.trace)
        extra = {"busy_s": busy, "window_s": ctx.trace.window_s}
        brk = harness.breakdown(ctx.trace, host)
    else:
        win = harness.timed_window(sess, args.seconds)
        result["attempted"], result["failed"] = win["units"], win["failed"]
        values = {"setup_s": setup_s}
        p95_ms = float(np.percentile(win["unit_s"], 95)) * 1e3
        if cell.kind == "train":
            values["train_samples_per_s"] = win["rate"]
            values["train_step_ms_p95"] = p95_ms
        else:
            values["score_samples_per_s"] = win["rate"]
        print(f"window: {win['units']} units in {win['window_end_s']:.3f} s, "
              f"{win['rate']:.3f} samples/s, median {np.median(win['unit_s']) * 1e3:.1f} ms, "
              f"p95 {p95_ms:.1f} ms (reported: the cell's end-to-end metrics)", file=sys.stderr)
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        extra, brk = {}, None
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gaps = harness.check(sess)
    limits = compare.load_limits(root, cell.name)
    result["correct"] = compare.verdict(gaps, limits) and result["failed"] == 0
    result["device"] = {"platform": "gpu" if device.type == "cuda" else device.type,
                        "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                                 else "cpu"),
                        "count": 1, "memory_peak_bytes": int(peak), **extra}
    if brk is not None:
        result["breakdown"] = brk
    result["checks"] = {k: {"value": gaps.get(k), "limit": limits.get(k)}
                        for k in sorted(set(gaps) | set(limits))}
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    result = run(args)
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded in this process: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
