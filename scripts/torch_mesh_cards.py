#!/usr/bin/env python3
"""``diagnose-sft`` on several cards, each mesh against one card, through the
multi-card entry (``torchrun --nproc-per-node N -m tst_torch``).

    python3 scripts/torch_mesh_cards.py [--ranks 4] [--platform gpu|cpu] [--out DIR]
        [--precision f32|bf16|both] [--quantize none|int4]

Runs ``synthetic-vsi:0.4`` (MCQ rows and numeric rows decoded with each
fold's adapter) at Qwen2.5-0.5B's width (``--platform cpu``: the tiny spec,
gloo, for a rehearsal) on one rank, then under ``torchrun`` with every mesh
of ``--ranks`` ranks that the model's widths allow, twice: in f32 on the
plain attention (the meshes' collectives against one rank's arithmetic: the
per-fold losses and s(x) must agree within f32 rounding) and in bf16 through
the kernels (one mesh, against one rank at the bf16 rank rule). Each run's
wall and train samples/s; every run under remat (one card holds the f32
plain attention's saves only so). ``--precision`` keeps one of the two;
``--quantize int4`` quantizes the base in every run (at Qwen2.5-0.5B's
widths, tensor=2 gives each rank 448 of o's 896 input rows, 3.5 int4 groups:
padded shards, and numeric rows decoded through the int4 kernel under
NCCL). Prints one JSON line a run and one for all; exits non-zero when a
run fails or disagrees.
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

#: f32 plain path: s(x) and the final loss within these of one rank's
F32_SX_ATOL, F32_LOSS_RTOL = 1e-4, 1e-4
#: bf16 through the kernels: s(x) ranked alike (the port's bf16 rank rule)
BF16_SPEARMAN = 0.99


def _run(argv, out, ranks, timeout):
    """One ``diagnose-sft`` run → (rc, wall s, report, s(x) list, log tail)."""
    from tst_torch.runtime.mesh import free_port

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    if ranks == 1:
        cmd = [sys.executable, "-m", "tst_torch", *argv, "--out", out]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(ranks),
               "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
               "-m", "tst_torch", *argv, "--out", out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout,
                          env=env)
    wall = time.perf_counter() - t0
    report, sx = None, None
    if proc.returncode == 0:
        with open(os.path.join(out, "report.json")) as f:
            report = json.load(f)
        with open(os.path.join(out, "sx.jsonl")) as f:
            sx = [json.loads(line)["s_x"] for line in f]
    return proc.returncode, wall, report, sx, (proc.stdout + proc.stderr)[-4000:]


def _spearman(a, b):
    from tst_torch.eval.parity import spearman

    return float(spearman(np.asarray(a), np.asarray(b)))


#: the meshes of 4 ranks run: each axis alone (data, the seq ring) and the
#: pairs (fold x tensor, data x tensor, fold x data, seq x tensor)
MESHES_4 = [(1, 4, 1, 1), (1, 1, 4, 1), (2, 1, 1, 2), (1, 2, 1, 2), (2, 2, 1, 1), (1, 1, 2, 2)]


def meshes(ranks: int, spec) -> list:
    """The (fold, data, seq, tensor) meshes of ``ranks`` ranks whose tensor
    axis the spec's heads, KV heads and ffn take."""
    shapes = MESHES_4 if ranks == 4 else [(1, ranks, 1, 1)]
    return [m for m in shapes if not (spec.n_kv_heads % m[3] or spec.n_heads % m[3]
                                      or spec.d_ff % m[3])]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--out", default=os.path.join(REPO, "runs", "mesh_cards"))
    parser.add_argument("--timeout", type=float, default=600)
    parser.add_argument("--precision", choices=["f32", "bf16", "both"], default="both")
    parser.add_argument("--quantize", choices=["none", "int4"], default="none")
    args = parser.parse_args(argv)
    from tst_torch.models.spec import spec_by_name

    name = "qwen2.5-0.5b" if args.platform == "gpu" else "tiny"
    base = ["diagnose-sft", "--platform", args.platform, "--bench", "synthetic-vsi:0.4",
            "--set", f"data.n={256 if args.platform == 'gpu' else 32}", "--k", "2",
            "--set", "optim.batch_size=16" if args.platform == "gpu" else "optim.batch_size=4",
            "--set", "optim.epochs=1", "--set", f"model.name={name}",
            "--set", "rf.cross_check=false", "--set", "data.max_len=512",
            "--set", "model.remat=true",  # the f32 plain attention's saves, one card
            "--set", f"model.quantize={args.quantize}"]
    f32 = ["--set", "model.dtype=float32", "--set", "model.use_pallas=false"]
    results, failed = [], []
    ref = {}
    for precision, extra, shapes in (("f32", f32, meshes(args.ranks, spec_by_name(name))),
                                     ("bf16", [], [(1, 2, 1, 2)])):
        if args.precision not in (precision, "both"):
            continue
        for shape in [(1, 1, 1, 1)] + shapes:
            quant = "" if args.quantize == "none" else f"_{args.quantize}"
            tag = f"{precision}{quant}_{'x'.join(map(str, shape))}"
            flags = [a for axis, n in zip(("fold", "data", "seq", "tensor"), shape)
                     for a in ("--set", f"mesh.{axis}={n}")]
            ranks = int(np.prod(shape))
            rc, wall, report, sx, log = _run(base + extra + flags, os.path.join(args.out, tag),
                                             ranks, args.timeout)
            row = {"run": tag, "ranks": ranks, "rc": rc, "wall_s": round(wall, 2)}
            if rc != 0:
                failed.append(tag)
                row["log"] = log
                print(json.dumps(row), flush=True)
                results.append(row)
                continue
            row.update(final_loss=report["final_loss"],
                       train_samples_per_sec=report["train_samples_per_sec"],
                       train_wall_s=report["train_wall_seconds"],
                       numeric_blind_mra=report.get("numeric_blind_mra"))
            if ranks == 1:
                ref[precision] = (report, sx)
            else:
                r1, sx1 = ref[precision]
                dsx = float(np.max(np.abs(np.asarray(sx) - np.asarray(sx1))))
                dloss = abs(report["final_loss"] - r1["final_loss"]) / abs(r1["final_loss"])
                rho = _spearman(sx, sx1)
                row.update(max_abs_dsx=dsx, final_loss_rel_diff=dloss, sx_spearman=rho)
                ok = (dsx <= F32_SX_ATOL and dloss <= F32_LOSS_RTOL if precision == "f32"
                      else rho >= BF16_SPEARMAN and math.isfinite(report["final_loss"]))
                if not ok:
                    failed.append(tag)
            print(json.dumps(row), flush=True)
            results.append(row)
    print(json.dumps({"mesh_cards": results, "failed": failed}))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
