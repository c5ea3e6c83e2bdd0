#!/usr/bin/env python3
"""Whether bf16 rounding alone moves the s(x) ranks that chip_smoke.py's
phase 22b holds at IBP_SPEARMAN: its debias-ibp run at other depths, with
a witness beside the gate's reading.

    python3 scripts/torch_ibp_rank_witness.py [--out FILE]

On the card, at 16 and at 32 layers (LAYERS): phase 22b's run (chip_smoke.LLAMA8B_IBP, the
ibp-vsibench preset on Llama-3-8B from a random init, 60 rows, one round)
through the CLI with the model cut to that many of its 32 layers; then
round 0's held-out MCQ s(x), on its final adapters, three ways: through
the kernels (the run's own scoring), through the bf16 plain path
(``use_pallas=False``) and through the f32 plain path (base weights and
adapters in f32). Prints one JSON line a depth with the Spearman of each
pair: kernels vs bf16 plain is the gate's reading; bf16 plain vs f32 plain
is what bf16 rounding alone does to the ranks on the same adapters.
``--out FILE`` writes the lines to FILE as well.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

#: 22b's depth, and the cut at which its gate read under IBP_SPEARMAN
LAYERS = (16, 32)


def reading(n_layers):
    """One depth's run and its three s(x), as the module docstring says."""
    from tst_torch import cli
    from tst_torch.eval.parity import spearman

    out_dir = tempfile.mkdtemp(prefix="tst_torch_ibp_witness_")
    t0 = time.perf_counter()
    with chip_smoke._CutDepth("llama3-8b", n_layers), chip_smoke._RecordIbp() as rounds:
        rc = cli.main(chip_smoke.LLAMA8B_IBP + ["--out", out_dir])
    if rc != 0:
        raise RuntimeError(f"debias-ibp at {n_layers} layers: rc={rc}")
    wall = time.perf_counter() - t0
    s_k, p_k, mcq = chip_smoke.round0_sx(rounds)
    s_p, p_p, _ = chip_smoke.round0_sx(rounds, use_pallas=False)
    s_32, p_32, _ = chip_smoke.round0_sx(rounds, f32=True, use_pallas=False)
    del rounds
    torch.cuda.empty_cache()

    def dprob(a, b):
        return float(np.abs(a - b)[mcq].max())

    return {"layers": n_layers, "rows": chip_smoke.LLAMA8B_IBP_N, "mcq_rows": int(mcq.sum()),
            "spearman_kernels_vs_bf16_plain": spearman(s_k, s_p),
            "spearman_bf16_plain_vs_f32_plain": spearman(s_p, s_32),
            "spearman_kernels_vs_f32_plain": spearman(s_k, s_32),
            "max_dprob_kernels_vs_bf16_plain": dprob(p_k, p_p),
            "max_dprob_bf16_plain_vs_f32_plain": dprob(p_p, p_32),
            "gate": chip_smoke.IBP_SPEARMAN, "run_s": wall}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    chip_smoke.phase_device()
    chip_smoke.phase_build(sass=False)
    card = torch.cuda.get_device_name(0)
    lines = []
    for n_layers in LAYERS:
        rec = {"device": card, **reading(n_layers)}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.writelines(json.dumps(rec) + "\n" for rec in lines)


if __name__ == "__main__":
    main()
