#!/usr/bin/env python3
"""Variants of the port's K3 and K4 kernels, built beside the real ones and
timed in one process on one NVIDIA GPU: the measurements behind K3's split
plan and K4's pipeline (PERF.md §6).

    python3 scripts/torch_kernel_variants.py

Each variant is the kernel's source with one text substitution, compiled by
nvcc into its own library under tst_torch/_build/variants/ and called
through the same C entry:

  * K3 (int4_matmul.cu), at every Qwen2.5-0.5B int4 leaf at M = 32 and 64:
    the real kernel at 1, 2, 4 and 8 K splits and at the split plan, and an
    empty kernel (it returns at once) at the plan: the floor of a call. Times
    are device µs a call, CUDA graph of 10 calls replayed (chip_smoke.graph_us).
  * K4 (fused_mlp.cu) at the train shape (16384, 896, 4864): the real
    kernels and a variant that keeps one wgmma group in flight across
    k-steps, giving a stage back one k-step later. CUDA-event medians.

Prints the card's name and power limit first, then one line per
measurement.
"""

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import tst_torch.kernels.fused_mlp as tfm  # noqa: E402
import tst_torch.kernels.quant_matmul as tqm  # noqa: E402
from tst_torch.kernels import _build  # noqa: E402
from tst_torch.models.quant import quantize_leaf  # noqa: E402

OUT = _build.BUILD_DIR / "variants"

K3_EMPTY = [("  using R = Smem<MT, S>;\n", "  using R = Smem<MT, S>;\n  if (M > 0) return;\n")]
K4_IN_FLIGHT = [
    ("  int tile = blockIdx.x, kb = 0;\n", "  int tile = blockIdx.x, kb = 0, held = -1;\n"),
    ("    wgmma_commit();\n    wgmma_wait<0>();\n    mbar_arrive(empty + 8 * s);\n"
     "    if (++kb < ksteps) continue;\n",
     "    wgmma_commit();\n    if (++kb < ksteps) {\n      wgmma_wait<1>();\n"
     "      if (held >= 0) mbar_arrive(empty + 8 * held);\n      held = s;\n      continue;\n"
     "    }\n    wgmma_wait<0>();\n    if (held >= 0) mbar_arrive(empty + 8 * held);\n"
     "    mbar_arrive(empty + 8 * s);\n    held = -1;\n"),
]


def build(variants):
    """{name: CDLL} of each (name, source, substitutions), compiled together."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, procs = _build.find_nvcc(), []
    for name, src, subs in variants:
        text = (_build.CSRC_DIR / src).read_text()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in {src}")
            text = text.replace(old, new)
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        cmd = [nvcc, "-gencode", _build.GENCODE, "-std=c++17", "-O3", "-shared", "-Xcompiler",
               "-fPIC", "-Xptxas", "-v", "-I", str(_build.CSRC_DIR), "-o", str(so), str(cu)]
        procs.append((name, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                 stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log = proc.communicate()[0]
        notes = [ln.strip() for ln in log.splitlines() if re.search(r"C75\d\d|error", ln)]
        print(f"[build] {name}: rc {proc.returncode}, {json.dumps(chip_smoke.ptxas_usage(log))}, "
              f"compiler notes {notes}")
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} does not build")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def k3(libs, device):
    g = torch.Generator(device=device).manual_seed(11)
    layer = {}
    for leaf_name, (k, n) in chip_smoke.QWEN_INT4.items():
        w = (torch.randn(2, k, n, device=device, generator=g) / math.sqrt(k)).to(torch.bfloat16)
        leaf = quantize_leaf(w, bits=4)
        q, sc = leaf["q"], leaf["scale"]
        for m in chip_smoke.INT4_M:
            y = torch.randn(m, k, device=device, generator=g).to(torch.bfloat16)
            plan = tqm.split_plan(k, n // 2)[0]
            for name, lib in libs.items():
                fn = lib.tst_int4_matmul
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                sweep = [plan] if name == "k3_empty" else sorted(
                    {s for s in (1, 2, 4, 8) if s <= k // 128} | {plan})
                for splits in sweep:
                    def call(splits=splits):
                        out = torch.empty(m, n, device=device, dtype=torch.float32)
                        err = fn(y.data_ptr(), q.data_ptr(), sc.data_ptr(), out.data_ptr(), m,
                                 k, n // 2, 1, splits, device.index,
                                 _build.current_stream(device))
                        if err:
                            raise RuntimeError(f"{name}: cudaError_t {err}")
                    us = chip_smoke.graph_us(call)
                    if splits == plan:
                        layer[(name, m)] = layer.get((name, m), 0.0) + us
                    print(f"[k3] {name} {leaf_name} M={m} K={k} N={n} splits={splits}"
                          f"{' (plan)' if splits == plan else ''}: {us:.2f} µs a call")
        del q, sc
    for (name, m), us in sorted(layer.items()):
        print(f"[k3] {name}: a layer's 7 projections at M={m}, at the plan: {us:.2f} µs")


def k4(libs, device):
    m, d, f = chip_smoke.MLP_SHAPES[0]
    g = torch.Generator(device=device).manual_seed(m + d)
    x = torch.randn(m, d, device=device, generator=g).to(torch.bfloat16)
    wg, wu = ((torch.randn(d, f, device=device, generator=g) / math.sqrt(d)).to(torch.bfloat16)
              for _ in range(2))
    wd = (torch.randn(f, d, device=device, generator=g) / math.sqrt(f)).to(torch.bfloat16)
    h = torch.empty(m, f, device=device, dtype=torch.bfloat16)
    out = torch.empty(m, d, device=device, dtype=torch.bfloat16)
    ref = tfm.swiglu_reference(x, wg, wu, wd)
    for name, lib in libs.items():
        gu, dn = lib.tst_swiglu_gate_up, lib.tst_swiglu_down
        gu.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        dn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        stream = _build.current_stream(device)
        run_gu = lambda: gu(x.data_ptr(), wg.data_ptr(), wu.data_ptr(), h.data_ptr(), m, d, f,
                            device.index, stream)
        run_dn = lambda: dn(h.data_ptr(), wd.data_ptr(), out.data_ptr(), m, f, d, device.index,
                            stream)
        if run_gu() or run_dn():
            raise RuntimeError(f"{name} failed to launch")
        torch.cuda.synchronize()
        err = chip_smoke._rel_err(out, ref)
        t_gu, t_dn = chip_smoke.median_ms(run_gu), chip_smoke.median_ms(run_dn)
        print(f"[k4] {name} ({m}, {d}, {f}): max|out-ref|/max|ref| {err:.3e}; gate-up "
              f"{t_gu:.4f} ms, down {t_dn:.4f} ms, both {t_gu + t_dn:.4f} ms (median of 30 x 10)")


def main():
    chip_smoke.phase_device()
    device = torch.device("cuda", torch.cuda.current_device())
    libs = build([("k3", "int4_matmul.cu", []), ("k3_empty", "int4_matmul.cu", K3_EMPTY),
                  ("k4", "fused_mlp.cu", []), ("k4_in_flight", "fused_mlp.cu", K4_IN_FLIGHT)])
    k3({n: lib for n, lib in libs.items() if n.startswith("k3")}, device)
    k4({n: lib for n, lib in libs.items() if n.startswith("k4")}, device)


if __name__ == "__main__":
    main()
