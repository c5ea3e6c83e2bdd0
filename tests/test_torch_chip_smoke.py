"""The pure gates of chip_smoke.py, held on the CPU: the SASS gate (every
attention kernel and both K4 kernels run their products on wgmma), the build
log's per-kernel registers and spills, the K3 first-token gate (no decisive
disagreement) and the relative per-fold loss bound. The phases that use them
run only on a card."""

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

_NS = "_ZN12_GLOBAL__N_1"
_ARGS = "EEEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiif"


def _mangled(kind, d, seg):
    name = {"fwd": "flash_fwd_kernel", "dkv": "flash_bwd_dkv_kernel",
            "dq": "flash_bwd_dq_kernel"}[kind]
    return f"{_NS}{len(name)}{name}ILi{d}ELb{int(seg)}{_ARGS}"


ATTENTION = [(kind, d, seg) for kind in ("fwd", "dkv", "dq") for d in (64, 128)
             for seg in (False, True)]
#: K4's kernels as the SASS listing names them
K4 = {"swiglu_gate_up_kernel": f"{_NS}21swiglu_gate_up_kernelEPK13__nv_bfloat16S2_S2_PS0_iii",
      "swiglu_down_kernel": f"{_NS}18swiglu_down_kernelEPK13__nv_bfloat16S2_PS0_iii"}


def _function(mangled, hgmma):
    return ([f"\t\tFunction : {mangled}",
             "\t.headerflags\t@\"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)\"",
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
            + ["        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], "
               "R24, gsb0 ;"] * hgmma
            + ["        /*0200*/                   EXIT ;"])


def _sass(kernels, hgmma=3, k4=tuple(K4), k4_hgmma=2):
    """A cuobjdump -sass listing: each attention kernel with `hgmma` HGMMA
    lines among others, the K4 kernels `k4` with `k4_hgmma`, and one kernel
    that is neither."""
    out = ["", "Fatbin elf code:", "================", "arch = sm_90a"]
    for kind, d, seg in kernels:
        out += _function(_mangled(kind, d, seg), hgmma)
    for name in k4:
        out += _function(K4[name], k4_hgmma)
    out += [f"\t\tFunction : {_NS}18int4_matmul_kernelILi1ELi2EEEv",
            "        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"]
    return "\n".join(out)


def test_hgmma_counts_name_all_twelve_attention_kernels():
    counts = chip_smoke.hgmma_counts(_sass(ATTENTION))
    assert len(counts) == chip_smoke.N_ATTENTION_KERNELS + len(chip_smoke.K4_KERNELS) == 14
    assert counts["fwd<D=64>"] == counts["fwd<D=128, seg>"] == counts["dq<D=64, seg>"] == 3
    assert counts["swiglu_gate_up_kernel"] == counts["swiglu_down_kernel"] == 2
    assert set(counts) == ({chip_smoke.kernel_name(_mangled(*k)) for k in ATTENTION}
                           | set(chip_smoke.K4_KERNELS))
    chip_smoke.check_hgmma(counts)


@pytest.mark.parametrize("case", ["forward missing", "forward without wgmma",
                                  "backward only"])
def test_hgmma_gate_fails_without_a_wgmma_forward(case):
    fwd = [k for k in ATTENTION if k[0] == "fwd"]
    bwd = [k for k in ATTENTION if k[0] != "fwd"]
    if case == "forward missing":
        sass = _sass(bwd + fwd[1:])
    elif case == "forward without wgmma":
        sass = _sass(bwd + fwd[1:]) + "\n" + _sass(fwd[:1], hgmma=0, k4=())
    else:
        sass = _sass(bwd)
    counts = chip_smoke.hgmma_counts(sass)
    with pytest.raises(AssertionError, match="wgmma"):
        chip_smoke.check_hgmma(counts)


@pytest.mark.parametrize("case", ["gate-up without wgmma", "down without wgmma",
                                  "down missing", "no K4 kernel"])
def test_hgmma_gate_fails_without_a_wgmma_k4_kernel(case):
    """Both K4 kernels must be in the listing, each with HGMMA."""
    if case == "gate-up without wgmma":
        sass = (_sass(ATTENTION, k4=("swiglu_down_kernel",)) + "\n"
                + _sass([], k4=("swiglu_gate_up_kernel",), k4_hgmma=0))
    elif case == "down without wgmma":
        sass = (_sass(ATTENTION, k4=("swiglu_gate_up_kernel",)) + "\n"
                + _sass([], k4=("swiglu_down_kernel",), k4_hgmma=0))
    elif case == "down missing":
        sass = _sass(ATTENTION, k4=("swiglu_gate_up_kernel",))
    else:
        sass = _sass(ATTENTION, k4=())
    counts = chip_smoke.hgmma_counts(sass)
    with pytest.raises(AssertionError, match="wgmma"):
        chip_smoke.check_hgmma(counts)


def test_ptxas_usage_names_each_kernel():
    fwd = _mangled("fwd", 64, True)
    mlp = ("_ZN45_GLOBAL__N__ddfb45a9_12_fused_mlp_cu_832a06f016fused_mlp_kernelILi8EEEvPK13"
           "__nv_bfloat16S3_S3_S3_PS1_iii")
    int4 = f"{_NS}18int4_matmul_kernelILi4ELi2EEEvPK13__nv_bfloat16PKaPKfPfiii"
    log = "\n".join([
        f"ptxas info    : Compiling entry function '{fwd}' for 'sm_90a'",
        f"ptxas info    : Function properties for {fwd}",
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]",
        f"ptxas info    : Compiling entry function '{mlp}' for 'sm_90a'",
        f"ptxas info    : Function properties for {mlp}",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 90 registers, 400 bytes cmem[0]",
        f"ptxas info    : Function properties for {_NS}16split_sum_kernelEPKfPfli",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        f"ptxas info    : Compiling entry function '{int4}' for 'sm_90a'",
        f"ptxas info    : Function properties for {int4}",
        "    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]",
    ])
    assert chip_smoke.ptxas_usage(log) == {
        "fwd<D=64, seg>": {"spill_bytes": 20, "registers": 168},
        "fused_mlp_kernel<8>": {"spill_bytes": 0, "registers": 90},
        "split_sum_kernel": {"spill_bytes": 0},
        "int4_matmul_kernel<4, 2>": {"spill_bytes": 32, "registers": 255}}


def _logits(rows):
    return torch.tensor(rows, dtype=torch.float32)


def test_near_tie_flip_is_no_decisive_disagreement():
    """Row 0 flips between two logits 0.01 apart (within 2 x 2e-2 x max|logit|
    = 0.4 at max|logit| 10): counted, not decisive. Row 1 agrees."""
    lp = _logits([[10.0, 9.99, 0.0], [1.0, 5.0, 0.0]])
    lk = _logits([[9.99, 10.0, 0.0], [1.0, 5.0, 0.0]])
    differ, decisive, gaps = chip_smoke.decisive_disagreements(lk, lp)
    assert (differ, decisive) == (1, 0)
    assert gaps == pytest.approx([0.01], abs=1e-5)


def test_decisive_flip_fails_the_gate():
    """Row 1's plain top-2 gap is 3.0, past 2 x 2e-2 x 10 = 0.4: an error the
    logit tolerance lets through could not have flipped it."""
    lp = _logits([[10.0, 9.99, 0.0], [1.0, 4.0, 0.0]])
    lk = _logits([[9.99, 10.0, 0.0], [4.0, 1.0, 0.0]])
    differ, decisive, gaps = chip_smoke.decisive_disagreements(lk, lp)
    assert (differ, decisive) == (2, 1)
    assert gaps == pytest.approx([0.01, 3.0], abs=1e-5)
    assert chip_smoke.decisive_disagreements(lk, lp, tol=0.2)[1] == 0


@pytest.mark.parametrize("loss_k,loss_p,ok", [
    ([13.0077, 12.9944], [13.0, 13.0], True),  # the measured gaps: 4-6e-4 of ~13 nats
    ([13.02, 13.0], [13.0, 13.0], False),      # 1.5e-3 of the loss
    ([0.5077], [0.5], False),                  # 7.7e-3 is too far from a loss of 0.5
    ([13.0], [math.nan], False),
])
def test_fold_loss_bound_is_relative(loss_k, loss_p, ok):
    gap, agree = chip_smoke.fold_losses_agree(loss_k, loss_p)
    assert agree is ok
    if ok:
        assert gap <= chip_smoke.LOSS_RTOL == 1e-3
