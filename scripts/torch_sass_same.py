#!/usr/bin/env python3
"""Whether two trees' builds of the port's kernels compile each attention
kernel to the same SASS: every kernel of this checkout's build against the
kernel of the same short name (``chip_smoke.kernel_name``: ``fwd<D=64>``,
``dkv_tiled<D=128, seg>``, ...) in another tree's build.

    python3 scripts/torch_sass_same.py --parent runs/parent
    python3 scripts/torch_sass_same.py --parent runs/parent --out chiprun_out/sass.json

Each tree's library is built by its own ``tst_torch.kernels._build`` in a
subprocess (nvcc, sm_90a), then listed with ``cuobjdump -sass``. A kernel's
SASS is its instruction text with addresses, encodings and the function's
own (mangled) name left out, so a kernel whose template gained an argument
compares equal when its instructions are unchanged. Prints one JSON object:
for each short name in both builds, whether its SASS is the same and its
instruction count in each; the names in one build only. Exits 1 if a kernel
that both builds hold differs. Needs nvcc (the card's machine)."""

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

_BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
          "from tst_torch.kernels import _build; r = _build.build(); "
          "print(r.path); print(_build.find_nvcc())")


def build(root):
    """``root``'s kernel library, built by its own builder → (path, nvcc)."""
    out = subprocess.run([sys.executable, "-c", _BUILD, os.path.abspath(root)], check=True,
                         capture_output=True, text=True, cwd=os.path.abspath(root)).stdout
    path, nvcc = out.strip().splitlines()[-2:]
    return path, nvcc


def attention_sass(lib, cuobjdump):
    """{short name: [instruction, ...]} of the attention kernels in ``lib``."""
    listing = subprocess.run([cuobjdump, "-sass", lib], check=True, capture_output=True,
                             text=True).stdout
    kernels, name = {}, None
    for ln in listing.splitlines():
        if "Function :" in ln:
            m = chip_smoke._FLASH_KERNEL.search(ln)
            name = chip_smoke.kernel_name(m[0]) if m else None
            if name:
                kernels[name] = []
        elif name:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
            if m:
                kernels[name].append(m[1])
    return kernels


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="the other tree (a checkout's root)")
    parser.add_argument("--out", default=None, help="also write the JSON object here")
    args = parser.parse_args(argv)
    here, nvcc = build(ROOT)
    there, _ = build(args.parent)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    a, b = attention_sass(here, cuobjdump), attention_sass(there, cuobjdump)
    both = sorted(set(a) & set(b))
    result = {"same": {k: a[k] == b[k] for k in both},
              "instructions": {k: [len(a[k]), len(b[k])] for k in both},
              "only_here": sorted(set(a) - set(b)), "only_parent": sorted(set(b) - set(a))}
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if all(result["same"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
