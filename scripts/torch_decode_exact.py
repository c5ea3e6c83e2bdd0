#!/usr/bin/env python3
"""Speculative decode's exactness on one NVIDIA GPU: the sources of F1 and
the decode-attention kernel's times (PERF.md §6, ROADMAP §3).

    python3 scripts/torch_decode_exact.py [--base int4 bf16] [--gammas 2 4]
        [--rows 32 27] [--compare-source OTHER.cu]

  * F1's sources. On Qwen2.5-0.5B at full width (random weights and a
    random rank-16 LoRA on q/k/v/o from the seed; chip_smoke.py's generate
    set), for each base (int4 through K3, or bf16 through the library), rows
    a call and gamma: the max |Δlogit| between gamma + 1 greedy steps (T=1,
    greedy decode's cache length) and one verify chunk (T = gamma + 1) over
    the same tokens in speculative decode's longer cache, after a rejected
    round's masked slots. It is printed with each source of F1 put back as
    it was before the repair (K3's split plan counting M's row tiles, the
    cache attention in torch's batched products and softmax, the library's
    products over the whole chunk in one call) or left repaired: "none" has
    all three put back, "all" is the code as it is, and must give 0.
  * With ``--compare-source``, the decode-attention kernel of the package
    and another build of its C entry (``tst_decode_attention``, e.g. the
    parent commit's ``tst_torch/csrc/decode_attention.cu``; an entry of the
    earlier signature, without scratch, is called as such),
    each held to the plain version and timed in turn (other, package,
    package, other) at every case of chip_smoke.py's DATTN_CASES and
    WIDTHS_DATTN: device µs a call from a CUDA graph, beside
    scaled_dot_product_attention with the mask (the same graph timing) and
    the bound.

Prints the card's name and power limit first, then one line per
measurement.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import tst_torch.kernels.decode_attention as tda  # noqa: E402
import tst_torch.kernels.quant_matmul as tqm  # noqa: E402
import tst_torch.models.decode as tdec  # noqa: E402
from tst_torch.kernels import _build  # noqa: E402


def _old_split_plan(m, k, n_half):
    """K3's split plan before F1's repair: the row tiles of M in the count."""
    groups = k // tqm.GROUP
    blocks = (n_half // tqm.NH_MULTIPLE) * -(-m // tqm.BLOCK_M)
    want = max(1, min(tqm.MAX_SPLITS, groups, -(-tqm.TARGET_BLOCKS // blocks)))
    return -(-groups // -(-groups // want))


def _old_k3_launch(y, q, scale, layer):
    """K3 through its C entry with the pre-repair plan."""
    m, k = y.shape
    out = torch.empty((m, 2 * q.shape[2]), dtype=torch.float32, device=y.device)
    err = tqm._entry()(y.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
                       q.shape[2], layer, _old_split_plan(m, k, q.shape[2]), y.device.index,
                       _build.current_stream(y.device))
    if err != 0:
        raise RuntimeError(f"K3 failed with cudaError_t {err}")
    return out


def _einsum_attention(q, k, v, mask):
    """The decode step's attention before F1's repair: torch's batched
    products and softmax, whose blocking follows T and S."""
    b, t, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, t, kvh, h // kvh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float()) / np.sqrt(d)
    probs = torch.softmax(scores.masked_fill(~mask[:, None, None], -1e30), dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskd->btkgd", probs.float(), v.float()).to(q.dtype).reshape(
        b, t, h, d)


def _whole_chunk(fn, y):
    """The library products before F1's repair: the whole chunk in one call."""
    return fn(y)


#: each source of F1: (module, attribute, its pre-repair stand-in)
PATCHES = {"k3": (tqm, "_launch", _old_k3_launch),
           "attention": (tdec, "cache_attention", _einsum_attention),
           "products": (tdec, "_by_position", _whole_chunk)}
#: which sources each case puts back as they were: none repaired, each
#: repaired alone, each left out, all repaired (the code as it is)
CASES = {"none": ("k3", "attention", "products"), "k3 plan": ("attention", "products"),
         "attention kernel": ("k3", "products"), "products by position": ("k3", "attention"),
         "all but k3 plan": ("k3",), "all but attention kernel": ("attention",),
         "all but products by position": ("products",), "all": ()}


def step_vs_chunk(params, spec, lora, lspec, tokens, plen, max_new, gamma):
    """max |Δlogit| between gamma + 1 greedy steps and one verify chunk over
    the same tokens (the chunk in speculative decode's cache, after a
    rejected round's slots of other keys and values)."""
    chunk, s, dev = gamma + 1, tokens.shape[1], tokens.device
    s_spec = s + max_new * chunk
    s_spec += (-s_spec) % 128
    with torch.inference_mode():
        tok0, kc, vc, head, rope = tdec.prefill(params, tokens, plen, max_new, spec, lora=lora,
                                                lora_spec=lspec, use_pallas=True)
        ar = torch.arange(kc.shape[2], device=dev)[None]
        kg, vg, cur, fed, steps = kc.clone(), vc.clone(), tok0, [], []
        for t in range(chunk):
            valid = (ar < plen[:, None]) | ((ar >= s) & (ar < s + t))
            lg, kg, vg = tdec.chunk_logits(params, lora, lspec, spec, cur[:, None],
                                           (plen + t)[:, None], s + t, valid, kg, vg,
                                           use_pallas=True, head=head, rope=rope)
            fed.append(cur)
            steps.append(lg[:, 0])
            cur = lg[:, 0].argmax(-1).to(torch.int32)
        shape = (kc.shape[0], kc.shape[1], s_spec) + tuple(kc.shape[3:])
        k2 = torch.randn(shape, device=dev).to(kc.dtype)
        v2 = torch.randn(shape, device=dev).to(vc.dtype)
        k2[:, :, :s], v2[:, :, :s] = kc[:, :, :s], vc[:, :, :s]
        valid = torch.arange(s_spec, device=dev)[None] < plen[:, None]
        lc, _, _ = tdec.chunk_logits(
            params, lora, lspec, spec, torch.stack(fed, 1),
            plen[:, None] + torch.arange(chunk, device=dev)[None], s + chunk, valid, k2, v2,
            use_pallas=True, head=head)
    return max((lc[:, t] - steps[t]).abs().max().item() for t in range(chunk))


def f1_sources(base, rows_list, gammas):
    from tst_torch import cli
    from tst_torch.models.lora import LoraSpec, init_lora
    from tst_torch.train.pipeline import prepare_blind_eval

    argv = chip_smoke.SERVE_GEN + ["--set", f"model.quantize={'none' if base == 'bf16' else base}"]
    cfg, device = cli._resolve(cli.build_parser().parse_args(argv))
    _, tokens, pos, spec, params = prepare_blind_eval(cli._load_dataset(cfg), cfg, device)
    g = torch.Generator(device=device).manual_seed(cfg.data.seed + 2)
    lspec = LoraSpec(dtype=spec.dtype)
    lora = init_lora(g, spec, lspec)
    for ab in lora.values():
        ab["b"] = (0.01 * torch.randn(ab["b"].shape, generator=g, device=device)).to(spec.dtype)
    plen = pos.long() + 1
    for rows in rows_list:
        for gamma in gammas:
            out = {}
            for name, old in CASES.items():
                saved = [(mod, attr, getattr(mod, attr))
                         for mod, attr, _ in (PATCHES[o] for o in old)]
                try:
                    for o in old:
                        setattr(PATCHES[o][0], PATCHES[o][1], PATCHES[o][2])
                    out[name] = step_vs_chunk(params, spec, lora, lspec, tokens[:rows],
                                              plen[:rows], chip_smoke.GEN_MAX_NEW, gamma)
                finally:
                    for mod, attr, fn in saved:
                        setattr(mod, attr, fn)
            print(f"[f1] {base} base, {rows} rows, gamma {gamma}: max|dlogit| step vs chunk, "
                  f"with the named source(s) repaired: "
                  + ", ".join(f"{key} {val:.4e}" for key, val in out.items()), flush=True)


def other_entry(source):
    """``tst_decode_attention`` of another source, built into its own library
    → (the entry, its scratch query, or None for a source of the one-kernel
    signature, before scratch)."""
    out = _build.BUILD_DIR / "compare" / f"libdattn_{Path(source).stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(_build.nvcc_command(_build.find_nvcc(), [Path(source)], out), check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(out))
    fn = lib.tst_decode_attention
    scratch = getattr(lib, "tst_decode_attention_scratch", None)
    fn.restype = ctypes.c_int
    fn.argtypes = (tda._entry().argtypes if scratch is not None else
                   [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p])
    if scratch is not None:
        scratch.restype = ctypes.c_long
        scratch.argtypes = [ctypes.c_int] * 6
    return fn, scratch


def compare_kernels(source, device):
    other, other_scratch = other_entry(source)

    def call_other(q, k, v, mask):
        b, t, h, d = q.shape
        s, kvh = k.shape[1], k.shape[2]
        out = torch.empty_like(q)
        tail = (1.0 / float(np.sqrt(d)), q.device.index, _build.current_stream(q.device))
        if other_scratch is not None:
            nbytes = other_scratch(b, t, s, h, kvh, d)
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
            err = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), None if scratch is None else scratch.data_ptr(), nbytes,
                        b, t, s, h, kvh, d, *tail)
        else:
            err = other(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                        out.data_ptr(), b, t, s, h, kvh, d, *tail)
        if err != 0:
            raise RuntimeError(f"{source}: cudaError_t {err}")
        return out

    for b, t, h, kvh, d, s in chip_smoke.DATTN_CASES + chip_smoke.WIDTHS_DATTN:
        q, k, v, mask = chip_smoke._dattn_case(device, b, t, h, kvh, d, s, seed=b * t + d)
        want = tda.cache_attention_reference(q, k, v, mask).float()
        errs = {name: (fn(q, k, v, mask).float() - want).abs().max().item()
                for name, fn in (("package", tda.cache_attention), ("other", call_other))}
        times = {"other": [], "package": []}
        for name, fn in (("other", call_other), ("package", tda.cache_attention),
                         ("package", tda.cache_attention), ("other", call_other)):
            times[name].append(chip_smoke.graph_us(lambda: fn(q, k, v, mask)))
        lib_ms, _, backend = chip_smoke.dattn_library_ms(q, k, v, mask)
        bound = chip_smoke.dattn_bound(q, k, mask)
        print(f"[dattn] q [{b}, {t}, {h}/{kvh}, {d}], cache {s} slots: max|out-ref| package "
              f"{errs['package']:.3e}, other {errs['other']:.3e}; device us a call (other, "
              f"package, package, other): other "
              + ", ".join(f"{x:.2f}" for x in times["other"]) + "; package "
              + ", ".join(f"{x:.2f}" for x in times["package"])
              + f"; library ({backend}) {lib_ms * 1e3:.2f}; bound {bound['bound_ms'] * 1e3:.3f} "
              f"({bound['bound_by']})", flush=True)
        del q, k, v, mask, want
        torch.cuda.empty_cache()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--base", nargs="*", default=["int4", "bf16"], choices=["int4", "bf16"])
    parser.add_argument("--rows", nargs="*", type=int, default=[chip_smoke.DECODE_ROWS, 27])
    parser.add_argument("--gammas", nargs="*", type=int, default=[2, 4])
    parser.add_argument("--compare-source", default=None)
    args = parser.parse_args(argv)
    device = chip_smoke.phase_device()
    _build.library()
    if args.compare_source:
        compare_kernels(args.compare_source, device)
    for base in args.base:
        f1_sources(base, args.rows, args.gammas)


if __name__ == "__main__":
    main()
