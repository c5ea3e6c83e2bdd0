#!/usr/bin/env python3
"""Where the time of the bench's Qwen2.5-0.5B train steps goes: the
fold-parallel step (k=5 x 4 rows of 512) and one fold-sequential step
(k=1 x 4 rows), each under the bench's remat="dots" and without remat.

    python3 scripts/torch_bench_profile.py [--steps 3] [--remat dots none] [--out FILE]

On the card, on the bench's own workload, weights and trainers
(tst_torch.bench): per step, the synchronized wall without the profiler
(median of ``--steps`` after one), then from a torch.profiler trace of
``--steps`` more: the device's busy ms (the sum of kernel times) and idle
share (1 - busy / wall), kernel launches and CPU ops a step, the host ops'
time at the top of their stacks, the five kernels with the most device
time, and the twelve CPU ops with the most host self time (an op's time
less its child ops'), each with its calls a step. Prints one JSON line a
step kind; ``--out FILE`` writes them all to FILE as well.
"""

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

#: the host's runtime calls that launch a kernel
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


def host_self_time(events):
    """From a Chrome trace's events: each CPU op name's (self µs, calls),
    and the µs of the ops at the top of their thread's stack."""
    threads = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "cpu_op":
            threads.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    ops, top_us = {}, 0.0

    def close(frame):
        end, name, dur, child = frame
        acc = ops.setdefault(name, [0.0, 0])
        acc[0] += dur - child
        acc[1] += 1

    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []
        for ev in evs:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0))
            while stack and stack[-1][0] <= ts:
                close(stack.pop())
            if stack:
                stack[-1][3] += dur
            else:
                top_us += dur
            stack.append([ts + dur, ev["name"], dur, 0.0])
        while stack:
            close(stack.pop())
    return ops, top_us


def profile_step(fn, steps):
    """``fn`` (one train step) → the readings of the module docstring."""
    from torch.profiler import ProfilerActivity, profile

    times = []
    for _ in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    wall_ms = statistics.median(times[1:]) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    kernels, _ = chip_smoke.trace_device_time(events)
    busy_ms = sum(us for us, _, _ in kernels) / 1e3 / steps
    launches = sum(1 for ev in events if ev.get("ph") == "X" and ev.get("name") in LAUNCH_CALLS)
    ops, top_us = host_self_time(events)
    return {
        "wall_ms": wall_ms, "busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / wall_ms if busy_ms else None,
        "launches_per_step": launches / steps,
        "cpu_ops_per_step": sum(n for _, n in ops.values()) / steps,
        "host_top_level_ops_ms": top_us / 1e3 / steps,
        "top_kernels": [f"{name[:60]} {us / 1e3 / steps:.3f} ms x{n / steps:g}"
                        for us, n, name in sorted(kernels, reverse=True)[:5]],
        "host_self_by_op": [f"{name[:48]} {us / 1e3 / steps:.3f} ms x{n / steps:g}"
                            for name, (us, n) in sorted(ops.items(),
                                                        key=lambda kv: -kv[1][0])[:12]],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--remat", nargs="+", default=["dots", "none"])
    parser.add_argument("--out", help="also write the readings to this JSON file")
    args = parser.parse_args(argv)
    device = chip_smoke.phase_device()
    chip_smoke.phase_build(sass=False)

    from tst_torch import bench
    from tst_torch.models.decoder import init_params
    from tst_torch.models.lora import LoraSpec
    from tst_torch.models.spec import spec_by_name
    from tst_torch.train.sft import FoldTrainer

    w = bench.bench_workload(True, 1, 1)
    spec = spec_by_name(w.spec_name)
    lspec = LoraSpec(rank=bench.LORA_RANK, alpha=bench.LORA_ALPHA, dtype=spec.dtype)
    params = init_params(torch.Generator(device).manual_seed(0), spec)
    arrays = bench._to(device, w.tb.tokens, w.tb.loss_mask, w.tb.answer_pos)
    out = []
    for remat in args.remat:
        for k, idx, kind in ((bench.K, w.batches[0], "fold-parallel k=5 x 4 rows"),
                             (1, w.batches[0][0:1], "one fold-sequential step, 4 rows")):
            trainer = FoldTrainer(spec, lspec, k=k, lr=bench.LR, total_steps=100,
                                  use_pallas=True, remat=False if remat == "none" else remat,
                                  t_max=w.t_max)
            lora, opt = trainer.init_state(torch.Generator(device).manual_seed(1))

            def step():
                return trainer.step(params, lora, opt, *arrays, idx)
            rec = {"step": kind, "remat": remat, **profile_step(step, args.steps)}
            print(json.dumps(rec), flush=True)
            out.append(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
