#!/usr/bin/env python3
"""``diagnose-sft`` on several cards, each mesh against one card, through the
multi-card entry (``torchrun --nproc-per-node N -m tst_torch``).

    python3 scripts/torch_mesh_cards.py [--ranks 4] [--platform gpu|cpu] [--out DIR]
        [--precision f32|bf16|both] [--quantize none|int4]
    python3 scripts/torch_mesh_cards.py --long [--ranks 4] [--platform gpu|cpu] [--out DIR]

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

``--long``: the long preset (``sft-videomme-long``: k=5, batch 2 a fold,
16,384 tokens, remat) with the sequence on the ring over ``--ranks`` cards,
``mesh.seq`` = ranks, on chip_smoke.py phase 21's synthetic long rows (6
rows of ~16,000 bytes; ``--platform cpu``: the tiny spec at 512 tokens,
gloo). First the multi-card entry, ``torchrun --nproc-per-node N -m
tst_torch diagnose-sft --preset sft-videomme-long --set mesh.seq=N ...``
(rc, wall, report); then, under torchrun too, this script's ring ranks on the
same state: K1's launches in one kernel-route step on each rank (causal and
non-causal, against what the rank's position on the ring implies,
chip_smoke.ring_launches_want, twice for the forward under remat), the step
gates of the kernel route against ``model.use_pallas=false`` (chip_smoke's
rule: per-fold losses within 1e-3, LoRA gradient cosine >= 0.999, over the
run's batches), and the step's ms (every step of one epoch, the median after
the first).
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


def _long_argv(rows, platform, seq):
    """The long preset on ``rows`` with the sequence over ``seq`` ranks."""
    argv = ["diagnose-sft", "--preset", "sft-videomme-long", "--bench", rows,
            "--platform", platform, "--set", "model.tokenizer=byte",
            "--set", "model.remat=true", "--set", "optim.epochs=1",
            "--set", "rf.cross_check=false", "--set", f"mesh.seq={seq}",
            "--set", "mesh.data=1", "--set", "mesh.tensor=1"]
    if platform == "cpu":  # a rehearsal: the tiny spec in f32 at 512 tokens
        argv += ["--set", "model.name=tiny", "--set", "model.dtype=float32",
                 "--set", "data.max_len=512"]
    return argv


def long_rank(rows, platform, out):
    """One rank of the ring's checks (under torchrun): the state of the
    long preset's run, then K1's launches in one kernel-route step, the step
    gates against the plain route, and the timed steps; rank 0 writes the
    ranks' readings to ``out`` as JSON."""
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from tst_torch import cli
    from tst_torch.runtime import mesh as mesh_mod
    from tst_torch.train.pipeline import _build_sft_state
    from tst_torch.train.sft import FoldTrainer

    mesh_mod.init_distributed()
    world = dist.get_world_size()
    cfg, device = cli._resolve(cli.build_parser().parse_args(_long_argv(rows, platform, world)))
    st = _build_sft_state(cli._load_dataset(cfg), cfg, device)
    idx = st.mesh.index("seq")
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def make(use_pallas):
        return FoldTrainer(st.spec, st.lspec, st.trainer.k, lr=cfg.optim.lr,
                           total_steps=st.batches.shape[0], use_pallas=use_pallas,
                           remat=st.trainer.remat, mesh=st.mesh, t_max=st.t_max, ring=True)

    arrays = (st.tokens, st.loss_mask, st.answer_pos)
    lora = cs.gate_adapters(make(True), device)
    cs._zero_launch_counts()
    make(True).batch_loss_and_grads(st.params, lora, *arrays, st.batches[0])
    sync()
    counts = cs._launch_counts()
    launches = {"causal": {key: counts[key] for key in ("fwd", "dkv", "dq")},
                "full": cs._full_launch_counts()}
    per = cs.ring_launches_want(world, [idx])
    layers = st.spec.n_layers
    on_card = device.type == "cuda"  # the CPU runs K1's plain versions: no launch
    want = {kind: {"fwd": 2 * layers * n * on_card, "dkv": layers * n * on_card,
                   "dq": layers * n * on_card}
            for kind, n in per.items()}  # remat: the forward again in the backward
    got = [cs.mean_loss_and_grads(make(up), st.params, lora, arrays, st.batches)
           for up in (True, False)]
    sync()
    line, ok = cs._step_gates(*got)
    trainer = make(True)
    lora_t, opt = st.lora, st.opt_state
    step_ms = []
    for idx_kb in st.batches:
        sync()
        t0 = time.perf_counter()
        lora_t, opt, _ = trainer.step(st.params, lora_t, opt, *arrays, idx_kb)
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    row = {"rank": dist.get_rank(), "seq_index": idx, "launches": launches,
           "launches_want": want, "launches_ok": launches == want, "gate": line,
           "gate_ok": bool(ok), "step_ms": step_ms}
    rows_all = [None] * world
    dist.all_gather_object(rows_all, row)
    if dist.get_rank() == 0:
        with open(out, "w") as f:
            json.dump({"ranks": rows_all, "n_batches": int(st.batches.shape[0]),
                       "batch_rows": int(st.batches.shape[1] * st.batches.shape[2])
                       if st.batches.ndim == 3 else None}, f)
    dist.barrier()
    dist.destroy_process_group()


def run_long(args):
    """``--long``: the multi-card entry on the long preset, then the ring
    ranks' checks (long_rank) → exit code."""
    import chip_smoke as cs
    from tst_torch.runtime.mesh import free_port

    os.makedirs(args.out, exist_ok=True)
    rows = os.path.join(args.out, "long.jsonl")
    if args.platform == "gpu":
        cs.long_rows(rows)
        from tst_torch.kernels import _build

        _build.build()  # once, before the ranks load it
    else:
        cs.long_rows(rows, nbytes=400)
    rc, wall, report, sx, log = _run(_long_argv(rows, args.platform, args.ranks),
                                     os.path.join(args.out, "long_cli"), args.ranks,
                                     args.timeout)
    cli_row = {"run": f"long seq={args.ranks} (torchrun -m tst_torch)", "rc": rc,
               "wall_s": round(wall, 2)}
    if rc == 0:
        cli_row.update(final_loss=report["final_loss"], train_steps=report["train_steps"],
                       train_samples_per_sec=report["train_samples_per_sec"],
                       train_wall_s=report["train_wall_seconds"],
                       sx_finite=all(math.isfinite(x) for x in sx))
    else:
        cli_row["log"] = log
    print(json.dumps(cli_row), flush=True)
    gate_out = os.path.join(args.out, "long_ring_ranks.json")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", str(args.ranks),
           "--master-addr", "127.0.0.1", "--master-port", str(free_port()),
           os.path.abspath(__file__), "--long-rank", "--rows", rows, "--platform",
           args.platform, "--out", gate_out]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=args.timeout,
                          env=env)
    ranks_row = {"run": f"long seq={args.ranks} ring ranks (gates, launches, step ms)",
                 "rc": proc.returncode, "wall_s": round(time.perf_counter() - t0, 2)}
    if proc.returncode == 0:
        with open(gate_out) as f:
            ranks_row.update(json.load(f))
        medians = [float(np.median(r["step_ms"][1:] or r["step_ms"]))
                   for r in ranks_row["ranks"]]
        ranks_row["step_ms_median"] = max(medians)
    else:
        ranks_row["log"] = (proc.stdout + proc.stderr)[-4000:]
    print(json.dumps(ranks_row), flush=True)
    ok = (rc == 0 and cli_row["sx_finite"] and proc.returncode == 0
          and all(r["launches_ok"] and r["gate_ok"] for r in ranks_row["ranks"]))
    print(json.dumps({"long_ring": [cli_row, ranks_row], "ok": ok}))
    return 0 if ok else 1


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    parser.add_argument("--out", default=os.path.join(REPO, "runs", "mesh_cards"))
    parser.add_argument("--timeout", type=float, default=600)
    parser.add_argument("--precision", choices=["f32", "bf16", "both"], default="both")
    parser.add_argument("--quantize", choices=["none", "int4"], default="none")
    parser.add_argument("--long", action="store_true",
                        help="the long preset with the sequence on the ring over --ranks")
    parser.add_argument("--long-rank", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--rows", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.long_rank:
        long_rank(args.rows, args.platform, args.out)
        return
    if args.long:
        sys.exit(run_long(args))
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
