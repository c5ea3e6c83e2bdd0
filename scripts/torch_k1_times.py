#!/usr/bin/env python3
"""K1 (the flash-attention kernels of tst_torch) on one card: checked against
their plain versions, then timed beside torch's scaled_dot_product_attention
and the bound at the shapes where they serve the main paths.

    python3 scripts/torch_k1_times.py                    # this checkout
    python3 scripts/torch_k1_times.py --root runs/parent # another tree's tst_torch
    python3 scripts/torch_k1_times.py --rounds 2 --out k1.jsonl

``--root`` imports ``tst_torch`` and ``chip_smoke`` from that tree (its own
build, its own helpers), so two commits are compared in one call by running
the script once per tree, in turns. Shapes (B, S, H, KVH, D): the train
step's [32, 512, 14, 64]; the packed step's [32, 1024, 14, 64] with starts
from ``chip_smoke._seg_starts``; Llama-3-8B's [40, 512, 32, 128]; the 8B
packed leg's [5, 1024, 32, 128] (segmented), with those starts and with the
bench's own (``chip_smoke._bench_seg_cases``, the k=5 leg's first batch);
the long preset's [10, 16384, 14, 64]; non-causal, the ring's block at the
long preset [10, 4096, 14, 64] and at Llama-3-8B's heads [1, 4096, 32, 128].
Each kernel's time is the median over CUDA-event samples of back-to-back
calls (``chip_smoke.median_ms``), in ``--rounds`` rounds; the library is
timed in the same round. Prints JSON lines as it goes: the build (ptxas
registers, spills and its ``Performance Loss`` lines), then one a check (each kernel against its plain version at small
shapes, S = 576, 64 and 1088 among them, plain, segmented and non-causal,
and a second call bit-equal; the forwards first), then one a shape and round
(``ms``, ``library_ms``, ``bound_ms``, ``ratio_to_library``,
``share_of_bound``, and the card's SM clock and power draw read by
``nvidia-smi`` just after the shape's dQ timing). Exits 1 if a check fails. Needs a
CUDA device."""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

#: (name, (B, S, H, KVH, D), starts): None unsegmented, "random" from
#: chip_smoke._seg_starts, "bench" the bench's packed 8B leg's own, "full"
#: non-causal
SHAPES = [("train", (32, 512, 14, 2, 64), None), ("packed", (32, 1024, 14, 2, 64), "random"),
          ("llama8b", (40, 512, 32, 8, 128), None),
          ("llama8b_packed", (5, 1024, 32, 8, 128), "random"),
          ("llama8b_packed_bench", (5, 1024, 32, 8, 128), "bench"),
          ("long", (10, 16384, 14, 2, 64), None),
          ("ring_block", (10, 4096, 14, 2, 64), "full"),
          ("ring_block_llama", (1, 4096, 32, 8, 128), "full")]
#: (B, S, H, KVH, D, starts), starts as in SHAPES
CHECKS = [(2, 576, 4, 2, 64, None), (2, 576, 8, 2, 128, None), (3, 64, 14, 2, 64, None),
          (2, 64, 8, 2, 128, None), (4, 576, 14, 2, 64, "random"),
          (4, 1024, 8, 2, 128, "random"), (2, 4096, 14, 2, 64, None),
          (2, 576, 14, 2, 64, "full"), (2, 64, 8, 2, 128, "full"), (2, 1088, 28, 4, 128, "full")]


def _inputs(cs, b, s, h, kvh, d, seed, device):
    rng = np.random.default_rng(seed)
    q, do = (cs._randn(rng, (b, s, h, d), device) for _ in range(2))
    k, v = (cs._randn(rng, (b, s, kvh, d), device) for _ in range(2))
    return q, k, v, do


def checks(cs, tfa, device, emit):
    """Each kernel against its plain version and bit-equal on a second call,
    the forwards first; ``emit`` each row as it is made."""
    out = []
    for bwd in (False, True):
        for b, s, h, kvh, d, starts in CHECKS:
            q, k, v, do = _inputs(cs, b, s, h, kvh, d, s + d, device)
            seg = (torch.from_numpy(cs._seg_starts(b, s, s)).to(device) if starts == "random"
                   else None)
            causal = starts != "full"
            o, lse = tfa.flash_attention(q, k, v, causal=causal, seg_starts=seg)
            torch.cuda.synchronize()
            row = {"shape": [b, s, h, kvh, d], "starts": starts}
            if not bwd:
                again = tfa.flash_attention(q, k, v, causal=causal, seg_starts=seg)
                o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=causal,
                                                               seg_starts=seg)
                row.update(kernel="fwd", o_err=(o.float() - o_ref.float()).abs().max().item(),
                           lse_err=(lse - lse_ref).abs().max().item(),
                           bitwise=torch.equal(o, again[0]) and torch.equal(lse, again[1]))
                row["ok"] = bool(row["o_err"] <= cs.O_TOL and row["lse_err"] <= cs.LSE_TOL
                                 and row["bitwise"] and bool(torch.isfinite(o).all()))
                out.append(row)
                emit(row)
                continue
            di = tfa.backward_row_stat(o, do)
            got = tfa.flash_attention_backward(q, k, v, lse, di, do, causal, seg_starts=seg)
            torch.cuda.synchronize()
            again = tfa.flash_attention_backward(q, k, v, lse, di, do, causal, seg_starts=seg)
            want = tfa.flash_attention_backward_reference(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal,
                seg_starts=seg)
            row.update(kernel="bwd", grad_rel_errs=[cs._rel_err(g, w) for g, w in zip(got, want)],
                       bitwise=all(torch.equal(x, y) for x, y in zip(got, again)))
            row["ok"] = bool(max(row["grad_rel_errs"]) <= cs.GRAD_TOL and row["bitwise"]
                             and all(bool(torch.isfinite(t).all()) for t in got))
            out.append(row)
            emit(row)
    return out


def _starts(cs, shape, starts):
    b, s = shape[:2]
    if starts == "random":
        return cs._seg_starts(b, s, s)
    return next(seg for case, seg in cs._bench_seg_cases() if tuple(case) == tuple(shape))


def clocks():
    """The card's SM clock and power draw now, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]


def times(cs, tfa, device, name, shape, starts):
    b, s, h, kvh, d = shape
    causal = starts != "full"
    q, k, v, do = _inputs(cs, b, s, h, kvh, d, 1, device)
    seg = (None if starts in (None, "full")
           else torch.from_numpy(_starts(cs, shape, starts)).to(device))
    kseg = tfa.kernel_seg_starts(seg, q, causal)
    o, lse = tfa.flash_attention(q, k, v, causal=causal, seg_starts=seg)
    di = tfa.backward_row_stat(o, do)
    n = (5, 3) if s > 4096 else (30, 10)
    ms = {"fwd": cs.median_ms(lambda: tfa._launch_fwd(q, k, v, kseg, causal), *n),
          "dkv": cs.median_ms(lambda: tfa._launch_bwd_dkv(q, k, v, do, lse, di, kseg, causal),
                              *n),
          "dq": cs.median_ms(lambda: tfa._launch_bwd_dq(q, k, v, do, lse, di, kseg, causal), *n)}
    clock = clocks()
    mask = None if seg is None else tfa.segment_mask(seg, s)
    lib = cs._sdpa_yardstick(q, k, v, do, o, mask, *n, causal=causal)
    bounds = cs._attention_bounds(q, k, seg, causal)
    row = {"name": name, "shape": list(shape), "starts": starts,
           "library": f"{lib['backend']}, {lib['gqa']}", "clocks_sm_power": clock}
    for key in ("fwd", "dkv", "dq"):
        library_ms = lib["fwd_ms"] if key == "fwd" else lib["bwd_ms"]
        row[key] = {"ms": ms[key], "library_ms": library_ms, **bounds[key],
                    "ratio_to_library": ms[key] / library_ms,
                    "share_of_bound": bounds[key]["bound_ms"] / ms[key]}
    row["pair_ms"] = ms["dkv"] + ms["dq"]
    row["pair_ratio_to_library"] = row["pair_ms"] / lib["bwd_ms"]
    return row


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the tree whose tst_torch and chip_smoke run")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--only", nargs="*", default=None, help="shape names to time")
    parser.add_argument("--no-checks", action="store_true")
    parser.add_argument("--out", default=None, help="also append the lines to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k1_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke as cs
    import tst_torch.kernels.flash_attention as tfa
    from tst_torch.kernels import _build

    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    ok = True

    def emit(line):
        text = json.dumps(line, default=float)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    res = _build.build()
    usage = {k: u for k, u in cs.ptxas_usage(res.log).items() if k.startswith(("fwd", "dkv", "dq"))}
    emit({"root": root, "card": smi, "build_s": res.seconds, "ptxas": usage,
          "warnings": [ln.strip() for ln in res.log.splitlines()
                       if any(w in ln for w in ("arning", "Performance", "serializ"))]})
    if not args.no_checks:
        rows = checks(cs, tfa, device, emit)
        ok = all(r["ok"] for r in rows)
        emit({"checks_ok": ok})
    for rnd in range(args.rounds):
        for name, shape, starts in SHAPES:
            if args.only and name not in args.only:
                continue
            emit({"round": rnd, **times(cs, tfa, device, name, shape, starts)})
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
