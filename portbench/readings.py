"""The readings behind a cell's limits, on the card at the cell's own size
(not run by the benchmark's runs).

    python3 -m portbench.readings --workload <cell> --seeds 1 2 ... \
        [--control 1 2 3] [--seconds 3] [--out FILE]

For every seed of ``--seeds``: the program's numbers as a run compares them
(the checked first steps, or a short window of scoring calls), against the
float32 reference: the lower readings. For every seed of ``--control``
also the control, the reference with float8 operands in the program's place,
and for a training cell the faults planted in the reference's place (each
fold's batch cut to its first half; one target token altered in each
fold's batch), each against the float32 reference: the upper readings. A
state left unchanged reads 1 by the training numbers' measure and needs no
run. One JSON line a reading, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from portbench import compare, harness


def emit(rec, out):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(harness.ROOT), help="the checkout's root")
    ap.add_argument("--device", default="cuda", help="cuda, or cpu for a rehearsal")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload, Path(args.root))
    device = torch.device(args.device)
    for seed in args.seeds:
        t0 = time.perf_counter()
        sess = harness.session(cell, seed, device)
        sess.check_steps()
        rec = {"workload": cell.name, "seed": seed}
        if cell.kind == "score":
            win = harness.timed_window(sess, args.seconds)
            rec["rows_scored"] = win["units"] * sess.samples_per_unit()
        harness.sync(device)
        rec["program_s"] = time.perf_counter() - t0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        sess.free_program()
        t1 = time.perf_counter()
        if cell.kind == "train":
            ref = sess.reference()
            rec["program"] = sess.gaps(ref)
        else:
            rows = sess.sample()
            ref = sess.reference_probs(rows)
            rec["program"] = sess.gaps_against(rows, ref)
        rec["reference_s"] = time.perf_counter() - t1
        if seed in args.control:
            t2 = time.perf_counter()
            if cell.kind == "train":
                rec["control"] = compare.train_gaps(sess.reference(quant="fp8"), ref)
                rec["control_s"] = time.perf_counter() - t2
                for fault in ("half", "token"):
                    rec[f"fault_{fault}"] = compare.train_gaps(sess.reference(fault=fault), ref)
            else:
                ctl = sess.reference_probs(rows, quant="fp8")
                rec["control"] = {"prob": compare.prob_gap([c[None] for c in ctl], ref)}
                rec["control_s"] = time.perf_counter() - t2
        emit(rec, args.out)
        del sess
        harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
