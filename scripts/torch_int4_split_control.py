#!/usr/bin/env python3
"""How far a mesh's adapters drift from one process's, with and without the
padded int4 shards of a row-parallel projection whose rows split a group.

    python3 scripts/torch_int4_split_control.py

On gloo ranks on the CPU (tests/_torch_mesh_ranks.py ``train_one``: 3
AdamW steps, k=2, LoRA r4 on q, k, v, o and down, f32): ``small`` with
d_model 384, 24 heads and d_ff 384 quantized to int4 (tensor=2 gives each
rank 192 of o's and down's input rows, 1.5 groups: padded shards), and two
controls that pad nothing: int4 at d_model 256, 16 heads, d_ff 256 (128 rows
a rank, whole groups) and the d_model-384 model unquantized. Each on
(data=2, tensor=2), (tensor=2) and (data=2), against one process: the
per-fold losses' largest relative gap, the probabilities' largest absolute
gap, the adapters' largest absolute gap, and the worst adapter element's
gap over ``1e-6 + 1e-4·|one process|`` (the adapter tolerance of
tests/test_torch_mesh.py ``test_sharded_training_matches_one_process``: above
1 that test would fail). One line a case.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from _torch_mesh_ranks import run_ranks, train_one, train_rank  # noqa: E402

SPLIT = {"d_model": 384, "n_heads": 24, "d_ff": 384}
CASES = {
    "int4 d_model 384 (tensor=2 pads: 192 rows a rank)": dict(quantize=4, overrides=SPLIT),
    "int4 d_model 256 (tensor=2 whole groups: 128 rows a rank)": dict(
        quantize=4, overrides={"d_model": 256, "n_heads": 16, "d_ff": 256}),
    "f32 d_model 384 (unquantized)": dict(quantize=None, overrides=SPLIT),
}
SHAPES = [(1, 2, 1, 2), (1, 1, 1, 2), (1, 2, 1, 1)]
RTOL, ATOL = 1e-4, 1e-6


def worst_element(lora, one):
    """(largest |d| / (ATOL + RTOL·|one|), its leaf and index, largest |d|)."""
    ratio, where, dmax = 0.0, None, 0.0
    for p, ab in one.items():
        for n, want in ab.items():
            d = np.abs(lora[p][n] - want)
            r = d / (ATOL + RTOL * np.abs(want))
            i = np.unravel_index(np.argmax(r), r.shape)
            dmax = max(dmax, float(d.max()))
            if r[i] > ratio:
                ratio, where = float(r[i]), f"{p}.{n}[{', '.join(map(str, i))}]"
    return ratio, where, dmax


def main():
    cfgs = [dict(spec_name="small", **case) for case in CASES.values()]
    ones = [train_one((1, 1, 1, 1), **cfg) for cfg in cfgs]
    for shape in SHAPES:
        runs = run_ranks(train_rank, int(np.prod(shape)),
                         [dict(shape=shape, **cfg) for cfg in cfgs], deadline_s=600)
        for name, (losses, probs, lora), one in zip(CASES, runs[0], ones):
            ratio, where, dmax = worst_element(lora, one[2])
            print(f"mesh (fold, data, seq, tensor) {shape}, {name}: losses max rel gap "
                  f"{np.max(np.abs(losses - one[0]) / np.abs(one[0])):.3e}, probabilities max "
                  f"|d| {np.max(np.abs(probs - one[1])):.3e}, adapters max |d| {dmax:.3e}, "
                  f"worst |d| / ({ATOL} + {RTOL}·|one|) {ratio:.3f} at {where}", flush=True)


if __name__ == "__main__":
    main()
