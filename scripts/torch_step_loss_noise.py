#!/usr/bin/env python3
"""How far bf16 rounding alone moves the fold losses of the step gates'
paths, and how far a small fault moves them: the readings behind
chip_smoke.py's GATE_BATCHES.

    python3 scripts/torch_step_loss_noise.py [--batches 8] [--seeds 1 2]
        [--perturb 0.01 0.03] [--paths bench train] [--keys KEY ...] [--no-f32]
        [--out FILE]

On the card, for each gate case (``bench``: chip_smoke.bench_gate_cases,
phase 24's Qwen2.5-0.5B k=5 x 4 rows "dots", int8 Llama-3-8B k=2 x 2 rows
"dots" and packed int8 8B k=5 x 1 row of 1024 "attn", both at
chip_smoke.LLAMA8B_GATE_LAYERS of the 32 layers; ``train``:
chip_smoke.train_gate_cases, the diagnose-sft states of phases 7, 10, 14 and
22a), each adapter seed (chip_smoke.gate_adapters) and each of the path's
first ``--batches`` batches from one state: the fold losses and LoRA
gradients through the kernels, through the bf16 plain path
(``use_pallas=False``), through the f32 plain path (weights and adapters in
f32, losses only; not with ``--no-f32``), and through the kernels with every
layer's attention output scaled by 1 + eps for each ``--perturb`` eps (the
controls: a fault the gate must catch). Over the first n batches, n = 1, 2,
4, ..., averaged as the gate averages them: the max over folds of |d|/|loss|
of the kernel path against the bf16 plain path (the gate's reading), of each
bf16 path against f32, and of each control against the bf16 plain path,
with the LoRA gradients' least cosine. Also the single batches' readings
and the seconds of each case and seed. Prints one JSON line a case and seed;
``--out FILE`` writes them all to FILE as well.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def _gap(a, b):
    a, b = (np.asarray(x.tolist(), np.float64) for x in (a, b))
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _cos(ga, gb):
    return min(torch.nn.functional.cosine_similarity(
        ga[p][n].flatten(), gb[p][n].flatten(), dim=0).item() for p in ga for n in ga[p])


def run_case(case, seed, perturb, n_batches, f32=True):
    """One case and adapter seed → its readings (the module docstring)."""
    import tst_torch.models.decoder as dec
    from tst_torch.train.sft import tree_map

    device = case["arrays"][0].device
    spec32 = dataclasses.replace(case["spec"], dtype=torch.float32)
    kernel, plain = case["make"](case["spec"], True), case["make"](case["spec"], False)
    plain32 = case["make"](spec32, False) if f32 else None
    lora = chip_smoke.gate_adapters(kernel, device, seed)
    lora32 = tree_map(lambda t: t.float(), lora) if f32 else None
    params32 = chip_smoke._f32(case["params"]) if f32 else None
    paths = ["kernel", "plain"] + [f"control_{eps:g}" for eps in perturb]
    sums = {name: [0.0, None] for name in paths + (["f32"] if f32 else [])}
    batches = case["batches"][:n_batches]
    single, by_n = [], []
    attention = dec._flash_attention
    for t, idx in enumerate(batches):
        got = {}
        for name in paths:
            trainer = plain if name == "plain" else kernel
            if name.startswith("control"):
                eps = float(name.split("_")[1])
                dec._flash_attention = lambda *a, eps=eps: attention(*a) * (1.0 + eps)
            try:
                loss, grads = trainer.batch_loss_and_grads(case["params"], lora, *case["arrays"],
                                                           idx, case["segs"])
            finally:
                dec._flash_attention = attention
            got[name] = (loss.float(), tree_map(lambda g: g.float(), grads))
        single.append({"kernel_vs_plain": _gap(got["kernel"][0], got["plain"][0])})
        if f32:
            got["f32"] = (plain32.batch_loss_and_grads(params32, lora32, *case["arrays"], idx,
                                                       case["segs"])[0].float(), None)
            single[-1].update(plain_vs_f32=_gap(got["plain"][0], got["f32"][0]),
                              kernel_vs_f32=_gap(got["kernel"][0], got["f32"][0]))
        for name, (loss, grads) in got.items():
            acc = sums[name]
            acc[0] = acc[0] + loss
            if grads is not None:
                acc[1] = grads if acc[1] is None else tree_map(torch.add, acc[1], grads)
        n = t + 1
        if n & (n - 1) == 0 or n == len(batches):
            mean = {name: acc[0] / n for name, acc in sums.items()}
            row = {"n": n, "kernel_vs_plain": _gap(mean["kernel"], mean["plain"]),
                   "cos_kernel_vs_plain": _cos(sums["kernel"][1], sums["plain"][1])}
            if f32:
                row.update(plain_vs_f32=_gap(mean["plain"], mean["f32"]),
                           kernel_vs_f32=_gap(mean["kernel"], mean["f32"]))
            for name in paths[2:]:
                row[f"{name}_vs_plain"] = _gap(mean[name], mean["plain"])
                row[f"cos_{name}_vs_plain"] = _cos(sums[name][1], sums["plain"][1])
            by_n.append(row)
    torch.cuda.synchronize()
    del params32, lora32
    return {"case": case["name"], "key": case["key"], "seed": seed, "batches": len(batches),
            "rtol": chip_smoke.LOSS_RTOL, "single_batch": single, "averaged": by_n}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, default=8)
    parser.add_argument("--seeds", type=int, nargs="+", default=[1, 2])
    parser.add_argument("--perturb", type=float, nargs="*", default=[0.01, 0.03])
    parser.add_argument("--paths", nargs="+", choices=["bench", "train"],
                        default=["bench", "train"])
    parser.add_argument("--keys", nargs="*", default=None,
                        help="only the cases of these GATE_BATCHES keys")
    parser.add_argument("--no-f32", dest="f32", action="store_false")
    parser.add_argument("--out", help="also write the readings to this JSON file")
    args = parser.parse_args(argv)
    device = chip_smoke.phase_device()
    chip_smoke.phase_build(sass=False)
    out = []
    families = {"bench": lambda: chip_smoke.bench_gate_cases(device),
                "train": lambda: chip_smoke.train_gate_cases(args.keys)}
    for path in args.paths:
        for case in families[path]():
            if args.keys and case["key"] not in args.keys:
                continue
            for seed in args.seeds:
                t0 = time.perf_counter()
                rec = {**run_case(case, seed, args.perturb, args.batches, args.f32),
                       "seconds": time.perf_counter() - t0}
                print(json.dumps(rec), flush=True)
                out.append(rec)
            del case
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
