"""The pure gates of chip_smoke.py, held on the CPU: the SASS gate (every
attention kernel and both K4 kernels run their products on wgmma), the build
log's per-kernel registers and spills, the K3 first-token gate (no decisive
disagreement) and the relative per-fold loss bound, phases 15-17's gates, and
phases 18-19's checkpoint writer, HF-name exporter and launch arithmetic, and
phase 20's launch arithmetic of generate and speculative decode and its
token gate, phase 22's launch arithmetic at Llama-3-8B's 32 layers (IBP
under remat), its command lines and memory reckoning, and phase 11's
library yardstick for K3 (tinygemm's operands). The phases that use them
run only on a card."""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

_NS = "_ZN12_GLOBAL__N_1"
_ARGS = "EEvPK13__nv_bfloat16S3_S3_PKiPS1_Pfiiif"


def _mangled(kind, d, seg, tiled=False, causal=True):
    """A kernel's mangled name as the build names it: kSeg's flag unless seg
    is None (the persistent dK/dV kernel has none), then kCausal's (the
    64-row forward, causal only, has none); causal None: a name without it,
    as the kernels were named before they took kCausal."""
    name = {"fwd": "flash_fwd_kernel", "dkv": "flash_bwd_dkv_kernel",
            "dq": "flash_bwd_dq_kernel"}[kind]
    if tiled:
        name = name.replace("_kernel", "_tiled_kernel")
    flag = "" if seg is None else f"Lb{int(seg)}E"
    if causal is not None and not (kind == "fwd" and tiled):
        flag += f"Lb{int(causal)}E"
    return f"{_NS}{len(name)}{name}ILi{d}E{flag}{_ARGS}"


#: (kind, D, seg, tiled[, causal]) of each attention kernel the C entries
#: launch: the 64-row forward for packed rows at D=64, the 64-key dK/dV for
#: packed rows and at D=128, the 64-row dQ for packed rows (and non-causal at
#: D=128), the persistent kernels elsewhere; and the non-causal
#: instantiations of the unsegmented ones
ATTENTION = [("fwd", 64, False, False), ("fwd", 128, False, False), ("fwd", 64, True, True),
             ("fwd", 128, True, False), ("dkv", 64, None, False), ("dkv", 128, False, True),
             ("dkv", 64, True, True), ("dkv", 128, True, True)]
ATTENTION += [("dq", 64, None, False), ("dq", 128, None, False), ("dq", 64, True, True),
              ("dq", 128, True, True)]
ATTENTION += [("fwd", 64, False, False, False), ("fwd", 128, False, False, False),
              ("dkv", 64, None, False, False), ("dkv", 128, False, True, False),
              ("dq", 64, None, False, False), ("dq", 128, False, True, False)]
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
    for kernel in kernels:
        out += _function(_mangled(*kernel), hgmma)
    for name in k4:
        out += _function(K4[name], k4_hgmma)
    out += [f"\t\tFunction : {_NS}18int4_matmul_kernelILi1ELi2EEEv",
            "        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;"]
    return "\n".join(out)


def test_hgmma_counts_name_all_twelve_attention_kernels():
    """The twelve causal attention kernels and, since the non-causal branch,
    their six non-causal instantiations: eighteen, and the two K4 kernels."""
    counts = chip_smoke.hgmma_counts(_sass(ATTENTION))
    assert len(counts) == chip_smoke.N_ATTENTION_KERNELS + len(chip_smoke.K4_KERNELS) == 20
    assert counts["fwd<D=64>"] == counts["fwd<D=128, seg>"] == counts["dq_tiled<D=64, seg>"] == 3
    assert counts["fwd<D=64, full>"] == counts["dkv_tiled<D=128, full>"] == 3
    assert counts["swiglu_gate_up_kernel"] == counts["swiglu_down_kernel"] == 2
    assert set(counts) == ({chip_smoke.kernel_name(_mangled(*k)) for k in ATTENTION}
                           | set(chip_smoke.K4_KERNELS))
    chip_smoke.check_hgmma(counts)


def test_the_listing_names_the_kernels_the_gate_wants():
    assert ({chip_smoke.kernel_name(_mangled(*k)) for k in ATTENTION}
            == chip_smoke.ATTENTION_KERNELS)


@pytest.mark.parametrize("kernel,name", [
    (("fwd", 64, False, False, None), "fwd<D=64>"),
    (("fwd", 128, True, False, None), "fwd<D=128, seg>"),
    (("dkv", 64, None, False, None), "dkv<D=64>"),
    (("dkv", 64, None, False, True), "dkv<D=64>"),
    (("dkv", 64, None, False, False), "dkv<D=64, full>"),
    (("dkv", 128, False, True, False), "dkv_tiled<D=128, full>"),
    (("fwd", 64, True, True, None), "fwd_tiled<D=64, seg>"),
    (("dq", 64, None, False, True), "dq<D=64>"),
    (("dq", 64, None, False, False), "dq<D=64, full>"),
    (("dq", 128, True, True, True), "dq_tiled<D=128, seg>"),
    (("dq", 128, False, True, False), "dq_tiled<D=128, full>"),
])
def test_kernel_names_read_the_causal_flag(kernel, name):
    """kCausal false reads ``full``; the persistent dK/dV and dQ kernels' one
    flag is kCausal (they have no kSeg); a name without the flag is causal."""
    assert chip_smoke.kernel_name(_mangled(*kernel)) == name


@pytest.mark.parametrize("case", ["tiled without wgmma", "an unlaunched persistent kernel",
                                  "a tiled kernel in place of the persistent one"])
def test_hgmma_gate_holds_the_tiled_kernels_to_wgmma(case):
    """The 64-row kernels are held to wgmma like the others, and the listing
    must hold the launched set exactly: a kernel built and never launched
    (or launched in place of another) fails the gate."""
    if case == "tiled without wgmma":
        kernels = [k for k in ATTENTION if k != ("dkv", 64, True, True)]
        sass = _sass(kernels) + "\n" + _sass([("dkv", 64, True, True)], hgmma=0, k4=())
    elif case == "an unlaunched persistent kernel":
        sass = _sass(ATTENTION + [("fwd", 64, True, False)])
    else:
        sass = _sass([k for k in ATTENTION if k != ("fwd", 128, True, False)]
                     + [("fwd", 128, True, True)])
    counts = chip_smoke.hgmma_counts(sass)
    with pytest.raises(AssertionError, match="wgmma"):
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


# The gates of phases 15-17 (diagnose-rf, debias-ibp): each on a synthetic
# input that passes and on one that must fail.

def _ibp_report(n_alive, pruned, n_debiased):
    rows = [{"round": r, "n_alive": a, "pruned_this_round": p}
            for r, (a, p) in enumerate(zip(n_alive, pruned))]
    return {"per_round": rows, "n_debiased": n_debiased}


@pytest.mark.parametrize("n_alive,pruned,n_debiased,ok", [
    ([512, 461, 415], [51, 46, 41], 374, True),
    ([512, 461, 415], [51, 46, 41], 415, False),   # the last round's pruning left out
    ([512, 460, 415], [51, 46, 41], 374, False),   # round 1 does not follow round 0
    ([500, 450], [50, 45], 405, False),            # round 0 does not start from all rows
])
def test_ibp_audit_gate(n_alive, pruned, n_debiased, ok):
    report = _ibp_report(n_alive, pruned, n_debiased)
    if ok:
        chip_smoke.check_audit(report, 512)
    else:
        with pytest.raises(AssertionError, match="does not add up"):
            chip_smoke.check_audit(report, 512)


def test_ibp_audit_gate_reads_a_stopped_round_as_no_pruning():
    """A loop that stopped at its signals writes no pruned_this_round on the
    last row: that round pruned nothing."""
    report = _ibp_report([512, 461], [51], 461)
    chip_smoke.check_audit(report, 512)


@pytest.mark.parametrize("text,ok", [
    ('{"sx_seed_spearman": 0.5, "rounds": [1, 2]}', True),
    ('{"sx_seed_spearman": NaN}', False),
    ('{"rf_sft_spearman": -Infinity}', False),
])
def test_strict_json_gate(text, ok):
    if ok:
        assert chip_smoke.strict_json(text)["sx_seed_spearman"] == 0.5
    else:
        with pytest.raises(ValueError, match="not strict JSON"):
            chip_smoke.strict_json(text)


@pytest.mark.parametrize("case", ["agree", "kept column off", "row in both", "row missing"])
def test_ibp_split_gate(case):
    ids = [f"r{i}" for i in range(6)]
    kept, removed = ids[:4], ids[4:]
    sx = [{"id": i, "kept": 1.0 if i in kept else 0.0} for i in ids]
    if case == "kept column off":
        sx[0]["kept"] = 0.0
    elif case == "row in both":
        removed = removed + ["r0"]
    elif case == "row missing":
        kept = kept[1:]
    if case == "agree":
        chip_smoke.check_split(6, kept, removed, sx)
    else:
        with pytest.raises(AssertionError, match="IBP split"):
            chip_smoke.check_split(6, kept, removed, sx)


#: three rounds of Qwen2.5-0.5B: train steps, scorer chunks, decode prefills
IBP_PLAN = [{"steps": 51, "scorer_chunks": 14, "decode_chunks": 2},
            {"steps": 48, "scorer_chunks": 14, "decode_chunks": 2},
            {"steps": 42, "scorer_chunks": 12, "decode_chunks": 2}]


def test_ibp_launch_arithmetic():
    want = chip_smoke.ibp_launches_want(IBP_PLAN)
    assert want == {"fwd": 24 * (141 + 40 + 6), "dkv": 24 * 141, "dq": 24 * 141,
                    "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0, "int4": 0, "mlp": 0,
                    "dattn": 24 * 11 * 6}
    chip_smoke.check_launches(dict(want), want, "debias-ibp")


@pytest.mark.parametrize("key,delta", [("fwd", -24), ("dq", 24), ("fwd_seg", 24), ("int4", 1)])
def test_ibp_launch_gate_fails_off_the_plan(key, delta):
    """A round's scorer chunk not launched, a step too many, a segmented or
    int4 launch that the run cannot have made: each fails."""
    want = chip_smoke.ibp_launches_want(IBP_PLAN)
    with pytest.raises(AssertionError, match="debias-ibp: launches"):
        chip_smoke.check_launches({**want, key: want[key] + delta}, want, "debias-ibp")


@pytest.mark.parametrize("s_dev,ok", [
    ([0.9, 0.5, 0.5 + 1e-7, np.nan, 0.1], True),   # a tie the rounding breaks
    ([0.9, 0.5, 0.6, np.nan, 0.1], False),         # rows 1 and 2 swap decisively
    ([0.9, 0.5, 0.5, 0.3, 0.1], False),            # NaN in another row
])
def test_rf_ranking_gate(s_dev, ok):
    s_host = np.array([0.9, 0.5, 0.5, np.nan, 0.1])
    assert chip_smoke.same_ranking(np.array(s_dev), s_host) is ok


@pytest.mark.parametrize("pruned,ok", [([51, 46], True), ([51, 45], False), ([50, 46], False)])
def test_rf_ibp_pruning_gate(pruned, ok):
    report = _ibp_report([512, 461], pruned, 461 - pruned[1])
    assert chip_smoke.pruned_as_implied(report, 0.1) is ok


# Phases 18-19: the checkpoint writer, the HF-name exporter and the launch
# arithmetic of the Llama-width runs.

def test_safetensors_writer_read_back_by_safetensors(tmp_path):
    """write_safetensors's file, read by the safetensors package: every dtype
    the port's reader takes, bit for bit, a 0-d and an empty tensor too."""
    from safetensors.numpy import load_file

    from tst_torch import bridge

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, generator=g)
    tensors = {"bf16": x.bfloat16(), "f16": x.half(), "f32": x, "t": x.T,
               "i8": torch.randint(-128, 128, (7,), generator=g, dtype=torch.int8),
               "u8": torch.randint(0, 256, (2, 2, 3), generator=g, dtype=torch.uint8),
               "scalar": torch.tensor(2.5), "empty": torch.zeros(0, 4)}
    path = tmp_path / "w.safetensors"
    n = chip_smoke.write_safetensors(str(path), tensors)
    assert n == path.stat().st_size
    got = load_file(str(path))
    assert sorted(got) == sorted(tensors)
    for name, t in tensors.items():
        want = bridge.leaf_to_numpy(t.contiguous())
        assert got[name].dtype == want.dtype and got[name].shape == want.shape, name
        np.testing.assert_array_equal(got[name].reshape(-1).view(np.uint8),
                                      want.reshape(-1).view(np.uint8), err_msg=name)


def _config(spec, arch):
    return {"architectures": [arch], "vocab_size": spec.vocab_size, "hidden_size": spec.d_model,
            "num_hidden_layers": spec.n_layers, "num_attention_heads": spec.n_heads,
            "num_key_value_heads": spec.n_kv_heads, "intermediate_size": spec.d_ff,
            "head_dim": spec.d_head, "rope_theta": spec.rope_theta, "rms_norm_eps": spec.rms_eps,
            "tie_word_embeddings": spec.tie_embeddings,
            "max_position_embeddings": spec.max_seq_len}


@pytest.mark.parametrize("name,arch", [("small", "Qwen2ForCausalLM"),
                                       ("tiny", "LlamaForCausalLM")])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_exporter_inverted_by_the_loader(tmp_path, name, arch, dtype):
    """hf_state_dict + write_checkpoint, then the port's load_checkpoint:
    every leaf bit-equal to the tree written (a tied head, QKV biases; an
    untied head), and trees_equal names a leaf that differs."""
    import dataclasses

    from tst_torch.models.decoder import init_params
    from tst_torch.models.hf_load import load_checkpoint, spec_from_hf_config
    from tst_torch.models.spec import spec_by_name

    spec = spec_by_name(name, dtype=dtype)
    if arch.startswith("Qwen2"):
        spec = dataclasses.replace(spec, qkv_bias=True)
    else:
        spec = dataclasses.replace(spec, tie_embeddings=False)
    params = init_params(torch.Generator().manual_seed(1), spec)
    if spec.qkv_bias:
        params["layers"]["bq"] = torch.randn(params["layers"]["bq"].shape).to(dtype)
    path = tmp_path / "ckpt"
    nbytes, _ = chip_smoke.write_checkpoint(str(path), params, _config(spec, arch))
    assert nbytes == (path / "model.safetensors").stat().st_size
    loaded_spec = spec_from_hf_config(str(path), name=name)
    assert dataclasses.replace(loaded_spec, dtype=dtype) == spec
    loaded = load_checkpoint(str(path), spec, device=torch.device("cpu"))
    assert chip_smoke.trees_equal(loaded, params) == []
    assert ("lm_head" in loaded) != spec.tie_embeddings
    loaded["layers"]["wq"][1, 2, 3] += 1
    assert chip_smoke.trees_equal(loaded, params) == ["layers.wq"]
    del loaded["final_norm"]
    assert chip_smoke.trees_equal(loaded, params) == ["final_norm", "layers.wq"]


def test_published_configs_give_the_specs(tmp_path):
    """The config.json files phases 18 and 19 write give the port's named
    specs: Qwen2.5-0.5B whole, Llama-3-8B cut to LLAMA_LAYERS."""
    import dataclasses
    import json

    from tst_torch.models.hf_load import spec_from_hf_config
    from tst_torch.models.spec import spec_by_name

    for config, name, layers in ((chip_smoke.QWEN_CONFIG, "qwen2.5-0.5b", 24),
                                 (chip_smoke.LLAMA_CONFIG, "llama3-8b", chip_smoke.LLAMA_LAYERS)):
        (tmp_path / "config.json").write_text(json.dumps({**config, "num_hidden_layers": layers}))
        got = spec_from_hf_config(str(tmp_path), name=name)
        assert got == spec_by_name(name, n_layers=layers, max_seq_len=got.max_seq_len)


def test_llama_launch_arithmetic():
    """Phase 19's launches: full remat runs each layer's forward kernel twice
    a step (the forward, then the backward's recomputation), "flash" once;
    the int4 eval-blind's K3 launches; the multi-token scorer's forwards."""
    plain = chip_smoke.sft_launches_want(20, 10, 4)
    assert plain == {"fwd": 4 * 30, "dkv": 80, "dq": 80, "fwd_seg": 0, "dkv_seg": 0,
                     "dq_seg": 0, "int4": 0, "mlp": 0, "dattn": 0}
    assert chip_smoke.sft_launches_want(20, 10, 4, remat=True) == {**plain, "fwd": 4 * 50}
    assert chip_smoke.sft_launches_want(20, 10, 4, remat="dots")["fwd"] == 4 * 50
    assert chip_smoke.sft_launches_want(20, 10, 4, remat="flash") == plain
    assert chip_smoke.blind_int4_launches_want(8, 2, 4) == {
        "fwd": 40, "dkv": 0, "dq": 0, "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0,
        "int4": 7 * 4 * 11 * 2, "mlp": 0, "dattn": 4 * 11 * 2}
    assert chip_smoke.multitoken_launches_want(16, 4, 4) == 32
    assert chip_smoke.multitoken_launches_want(17, 4, 4) == 48


@pytest.mark.parametrize("case,ok", [("agree", True), ("wall only", True),
                                     ("accuracy", False), ("missing key", False)])
def test_checkpoint_report_gate(case, ok):
    """Phase 18 holds the checkpoint run's report to phase 4's in every key
    but the wall, floats exactly."""
    want = {"blind_accuracy": 0.3125, "n_mcq": 512, "model": "qwen2.5-0.5b",
            "wall_seconds": 9.1}
    got = dict(want)
    if case == "wall only":
        got["wall_seconds"] = 3.2
    elif case == "accuracy":
        got["blind_accuracy"] = 0.3125 + 1 / 512
    elif case == "missing key":
        del got["n_mcq"]
    assert (chip_smoke.same_report(got, want) == []) is ok


def _multitoken_ll(rng, rows=16, options=4, tokens=3, vocab=128256):
    """Summed log-probs of equal-length options at random weights: about
    -ln(vocab) a token, a few nats apart."""
    return -tokens * math.log(vocab) + rng.normal(0.0, 2.0, (rows, options))


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("cols,shift,ok", [([1], 0.05, True), ([1], 3.0, False),
                                           ([0, 1, 2, 3], 3.0, False)],
                         ids=["bf16-sized", "one option", "every option"])
def test_multitoken_gate_fails_an_attention_error(cols, shift, ok):
    """Equal-length options: a bf16-sized error in one option's summed
    log-probs passes; an error of a few nats fails, also where it moves
    every option alike and so leaves the probabilities as they were."""
    ll_p = _multitoken_ll(np.random.default_rng(0))
    ll_k = ll_p.copy()
    ll_k[:, cols] += shift
    got = chip_smoke.multitoken_agree(_softmax(ll_k), _softmax(ll_p), ll_k, ll_p)
    assert got[0] is ok


def test_multitoken_options_are_of_equal_length():
    """No option is padded, so none wins on length alone."""
    opts = np.array(chip_smoke.MULTI_OPTIONS)
    assert (opts >= 0).all() and len({tuple(o) for o in opts}) == len(opts)


def test_generate_launch_arithmetic():
    """Greedy generate on an int4 base: 128 rows in 4 chunks of 32, 16
    tokens: a prefill forward a layer a chunk, K3 on 7 projections a layer
    in each of the 15 steps after the prefill's token."""
    want = chip_smoke.generate_launches_want(4, 16, 24)
    assert want["fwd"] == 24 * 4 and want["int4"] == 7 * 24 * 15 * 4
    assert want["dattn"] == 24 * 15 * 4
    assert want["dkv"] == want["dq"] == want["mlp"] == want["fwd_seg"] == 0


def test_spec_launch_arithmetic():
    """Speculative decode: two prefills a chunk (target and draft); a round
    is gamma + 1 draft steps and one verify chunk, each with K3 on 7
    projections a layer."""
    want = chip_smoke.spec_launches_want(4, 30, 2, 24)
    assert want["fwd"] == 2 * 24 * 4 and want["int4"] == 7 * 24 * 4 * 30
    assert want["dattn"] == 24 * 4 * 30
    assert set(want) == set(chip_smoke.generate_launches_want(1, 2, 1))
    assert chip_smoke.spec_launches_want(1, 0, 4, 2)["int4"] == 0  # max_new = 1: no round


def test_first_divergence():
    a = np.array([[1, 2, 3], [1, 2, 3], [4, 5, 6]])
    b = np.array([[1, 2, 3], [1, 9, 3], [0, 5, 7]])
    np.testing.assert_array_equal(chip_smoke.first_divergence(a, b), [-1, 1, 0])


@pytest.mark.parametrize("margin,decisive", [(0.0, 0), (0.5, 0), (1.9, 0), (2.1, 1), (-3.0, 1)])
def test_spec_token_gate(margin, decisive):
    """A row whose speculative tokens differ from greedy's passes only when
    the plain path's logit margin between the two tokens at the first
    divergence is within 2 x LOGIT_TOL x max|logit| (here 2 x 0.02 x 50 =
    2); equal rows need no logits."""
    greedy = np.array([[5, 6, 7], [1, 2, 3]])
    spec = np.array([[5, 6, 7], [1, 4, 3]])
    lp = torch.zeros(1, 10)
    lp[0, 9] = 50.0  # sets max|logit|
    lp[0, 2], lp[0, 4] = 10.0 + margin, 10.0  # greedy's token 2, speculative's 4
    rows, n_decisive, margins = chip_smoke.spec_token_gate(greedy, spec, lp)
    assert rows.tolist() == [1] and n_decisive == decisive
    assert margins == pytest.approx([margin], abs=1e-5)
    rows, n_decisive, margins = chip_smoke.spec_token_gate(greedy, greedy, None)
    assert len(rows) == 0 and n_decisive == 0 and margins == []


def test_decode_attention_case_and_bound_count_the_visible_slots():
    """The decode attention's case: prompts of 100-499 slots, 3 generated
    slots at 512 and the chunk's triangle at S=640; its bound moves the keys
    and values of the slots a row's queries see, not of the whole cache."""
    b, t, h, kvh, d, s = 4, 3, 14, 2, 64, 640
    q, k, v, mask = chip_smoke._dattn_case(torch.device("cpu"), b, t, h, kvh, d, s, seed=0)
    plen = mask[:, 0, :512].sum(-1)
    assert ((plen >= 100) & (plen < 500)).all()
    assert mask[:, :, 512:515].all() and not mask[:, :, 518:].any()
    assert mask[:, :, 515:518].sum().item() == b * t * (t + 1) // 2
    seen = int(plen.sum()) + b * (3 + t)
    want_bytes = 2 * q.numel() * 2 + mask.numel() + 2 * seen * kvh * d * 2
    rec = chip_smoke.dattn_bound(q, k, mask)
    flops = 4 * d * h * int(mask.sum())
    assert rec["bound_ms"] == pytest.approx(max(flops / chip_smoke.PEAK_BF16_FLOPS,
                                                want_bytes / chip_smoke.PEAK_BYTES_PER_S) * 1e3)
    assert rec["bound_by"] == "bytes"
    whole = 2 * q.numel() * 2 + 2 * k.numel() * 2 + mask.numel()
    assert rec["bound_ms"] < 0.6 * whole / chip_smoke.PEAK_BYTES_PER_S * 1e3


def test_llama8b_launch_arithmetic():
    """Phase 22's launches at 32 layers: the preset's step under full remat
    (the forward twice a step), IBP rounds under remat with their decode
    prefills and steps, and the int4 eval-blind's K3 and decode attention."""
    assert chip_smoke.LLAMA8B_LAYERS == 32
    assert chip_smoke.sft_launches_want(9, 5, 32, remat=True) == {
        "fwd": 32 * 23, "dkv": 32 * 9, "dq": 32 * 9, "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0,
        "int4": 0, "mlp": 0, "dattn": 0}
    plan = [{"steps": 7, "scorer_chunks": 5, "decode_chunks": 2},
            {"steps": 6, "scorer_chunks": 5, "decode_chunks": 2}]
    want = chip_smoke.ibp_launches_want(plan, 32, remat=True)
    assert want == {"fwd": 32 * (2 * 13 + 10 + 4), "dkv": 32 * 13, "dq": 32 * 13,
                    "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0, "int4": 0, "mlp": 0,
                    "dattn": 32 * 11 * 4}
    assert chip_smoke.ibp_launches_want(plan, 32)["fwd"] == 32 * (13 + 10 + 4)
    assert chip_smoke.ibp_launches_want(plan, 32, remat="flash") == \
        chip_smoke.ibp_launches_want(plan, 32)
    with pytest.raises(AssertionError, match="debias-ibp: launches"):
        chip_smoke.check_launches(chip_smoke.ibp_launches_want(plan, 32), want, "debias-ibp")
    assert chip_smoke.blind_int4_launches_want(4, 1, 32) == {
        "fwd": 32 * 5, "dkv": 0, "dq": 0, "fwd_seg": 0, "dkv_seg": 0, "dq_seg": 0,
        "int4": 7 * 32 * 11, "mlp": 0, "dattn": 32 * 11}


def test_llama8b_phase_runs_the_presets_at_full_depth():
    """Phase 22's command lines: the two presets and Llama-3-8B by name (no
    checkpoint: every layer of the published geometry), on one card."""
    from tst_torch import cli
    from tst_torch.models.spec import spec_by_name

    for argv, preset in ((chip_smoke.LLAMA8B_TRAIN, "sft-mmmu-llama8b"),
                         (chip_smoke.LLAMA8B_IBP, "ibp-vsibench"), (chip_smoke.LLAMA8B_INT4, None)):
        args = cli.build_parser().parse_args(argv + ["--platform", "cpu"])
        cfg, _ = cli._resolve(args)
        assert args.preset == preset and cfg.model.path is None
        assert cfg.model.name == "llama3-8b" and cfg.model.tokenizer == "byte"
        assert (cfg.mesh.fold, cfg.mesh.data, cfg.mesh.seq, cfg.mesh.tensor) == (1, 1, 1, 1)
        if preset:
            assert cfg.data.k == 5 and cfg.model.remat is True
    assert spec_by_name("llama3-8b").n_layers == chip_smoke.LLAMA8B_LAYERS


def test_remat_memory_reckoning_at_llama8b():
    """The reckoning printed beside phase 22a's peak: Llama-3-8B's 8.03 B
    bf16 weights (16.06 GB) and 32 saved layer inputs of [40, 512, 4096]."""
    from tst_torch.models.spec import spec_by_name

    got = chip_smoke.remat_memory_reckoning(spec_by_name("llama3-8b"), 40, 512)
    assert got["weights_gb"] == pytest.approx(16.0605, abs=1e-3)
    assert got["saved_inputs_gb"] == pytest.approx(32 * 40 * 512 * 4096 * 2 / 1e9)
    tiny = spec_by_name("qwen2.5-0.5b")
    assert chip_smoke.remat_memory_reckoning(tiny, 1, 1)["weights_gb"] == pytest.approx(
        0.988, abs=2e-3)  # tied head: the embedding counted once


@pytest.mark.parametrize("k,n", [(896, 128), (4096, 1024)])
def test_tinygemm_yardstick_computes_k3s_function(k, n):
    """K3's library yardstick reads K3's leaf as tinygemm's unsigned
    nibbles and bf16 scales: on the CPU variant of the same op the product
    agrees with K3's plain version within LIB_INT4_TOL."""
    import tst_torch.kernels.quant_matmul as tqm
    from tst_torch.models.quant import quantize_leaf

    g = torch.Generator().manual_seed(0)
    w = (torch.randn(2, k, n, generator=g) / math.sqrt(k)).to(torch.bfloat16)
    leaf = quantize_leaf(w, bits=4)
    y = torch.randn(8, k, generator=g).to(torch.bfloat16)
    u, sz = chip_smoke.tinygemm_weights(leaf["q"], leaf["scale"], 1)
    assert u.shape == (n, k) and u.dtype == torch.uint8 and int(u.min()) >= 1
    assert sz.shape == (k // 128, n, 2) and not sz[..., 1].any()
    w4 = torch.ops.aten._convert_weight_to_int4pack_for_cpu(u.int(), 8)
    got = torch.ops.aten._weight_int4pack_mm_for_cpu(y, w4, chip_smoke.INT4_GROUP_SIZE, sz)
    want = tqm.int4_matmul_reference(y, leaf["q"], leaf["scale"], 1)
    assert chip_smoke._rel_err(got, want) <= chip_smoke.LIB_INT4_TOL
    # the other layer's weights give another product: the layer index is read
    other = tqm.int4_matmul_reference(y, leaf["q"], leaf["scale"], 0)
    assert chip_smoke._rel_err(got, other) > 0.5


def test_trace_device_time_sums_kernels_and_their_launching_ops():
    """The profile read from a Chrome trace: kernels summed by name; each
    kernel's time counted under the innermost CPU op around the runtime call
    that launched it (matched by correlation id), not under its parents."""

    def x(cat, name, ts, dur, tid=1, corr=None):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": tid}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    events = [
        x("cpu_op", "aten::linear", 0, 100), x("cpu_op", "aten::mm", 10, 30),
        x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=1),
        x("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=2),  # linear's own launch
        x("cpu_op", "aten::mul", 200, 10, tid=2),
        x("cuda_driver", "cuLaunchKernel", 203, 2, tid=2, corr=3),
        x("cuda_runtime", "cudaLaunchKernel", 300, 2, tid=2, corr=4),  # outside any op
        x("kernel", "gemm", 25, 40, tid=7, corr=1), x("kernel", "gemm", 70, 60, tid=7, corr=2),
        x("kernel", "mul_kernel", 210, 5, tid=7, corr=3),
        x("gpu_memcpy", "Memcpy DtoD", 305, 1, tid=7, corr=4),
        {"ph": "f", "cat": "ac2g", "name": "flow", "ts": 25, "id": 1},
    ]
    kernels, ops = chip_smoke.trace_device_time(events)
    assert sorted(kernels) == [(1.0, 1, "Memcpy DtoD"), (5.0, 1, "mul_kernel"),
                               (100.0, 2, "gemm")]
    assert sorted(ops) == [(5.0, "aten::mul"), (40.0, "aten::mm"), (60.0, "aten::linear")]


def test_entry_logit_gate_is_the_first_decode_steps_rule():
    """Phase 23 (a): entry()'s logits through the kernel no farther from the
    f32 plain forward than 1.25 times the bf16 plain path's own distance,
    plus 1e-3 · max|logit| (the first decode step's 2e-2 · max|logit| is
    reported); beyond it, a shape mismatch or a non-finite logit fails."""
    l32 = torch.linspace(-10.0, 10.0, 64).reshape(2, 32)
    lp = l32 + 0.1
    err_k, err_p, bound, abs_rule = chip_smoke.entry_logit_gate(l32 - 0.13, lp, l32)
    assert err_k == pytest.approx(0.13, abs=1e-6) and err_p == pytest.approx(0.1, abs=1e-6)
    assert bound == pytest.approx(1.25 * 0.1 + 1e-3 * 10, abs=1e-6)
    assert abs_rule == pytest.approx(0.2)
    # the bound follows the plain path's error, not the logits' size
    assert chip_smoke.entry_logit_gate(l32, l32, l32)[2] == pytest.approx(1e-2)
    for bad in (l32 + 0.14, (l32 + 0.1)[:, :16], torch.where(l32 > 9.0, torch.nan, l32)):
        with pytest.raises(AssertionError):
            chip_smoke.entry_logit_gate(bad, lp, l32)


@pytest.mark.parametrize("n", [1, 4, 8])
def test_dryrun_ok_line_is_parsed_and_gated(n):
    """Phase 23 (b, c): graft_entry's gate on the dry run's result for n
    ranks, and its OK line the last line printed; a result of another mesh,
    an inexact speculative decode, a ring error at the bound, a non-finite
    loss, a leg off the plain path, or another line printed fails."""
    from tst_torch import graft_entry as ge

    mesh = ge.mesh_shape(n)
    k = 2 * mesh["fold"]
    vs = {"step": {"loss_gap": 2e-4, "grad_cosine": 0.9995},
          "packed_step": {"loss_gap": 3e-4, "grad_cosine": 0.9993},
          "scorer": {"max_dprob": 4e-3},
          "decode": {"max_dlogit_rel": 6e-3, "differ": 0, "decisive": 0}}
    good = {"mesh": mesh, "k": k, "loss": 6.083, "packed_loss": 5.868, "decode": [k, 4, 4],
            "spec_exact": True, "ring_err": 5.96e-08, "vs_plain": vs}
    printed = f"log line\n{ge.ok_line(good)}\n"
    chip_smoke.dryrun_gate(good, printed, n, True)
    for bad in ({"spec_exact": False}, {"ring_err": ge.RING_TOL}, {"loss": float("nan")},
                {"decode": [k + 1, 4, 4]},
                {"vs_plain": {**vs, "step": {"loss_gap": 2e-3, "grad_cosine": 0.9995}}},
                {"vs_plain": {**vs, "packed_step": {"loss_gap": 0.0, "grad_cosine": 0.98}}},
                {"vs_plain": {**vs, "scorer": {"max_dprob": 0.06}}},
                {"vs_plain": {**vs, "decode": {**vs["decode"], "decisive": 1}}}):
        with pytest.raises(AssertionError):
            chip_smoke.dryrun_gate({**good, **bad}, ge.ok_line({**good, **bad}), n, True)
    no_vs = {key: val for key, val in good.items() if key != "vs_plain"}
    chip_smoke.dryrun_gate(no_vs, ge.ok_line(no_vs), n, False)
    with pytest.raises(AssertionError, match="vs_plain missing"):
        chip_smoke.dryrun_gate(no_vs, ge.ok_line(no_vs), n, True)
    with pytest.raises(AssertionError):
        chip_smoke.dryrun_gate(good, ge.ok_line(good), 2 * n, True)
    with pytest.raises(AssertionError, match="not its OK line"):
        chip_smoke.dryrun_gate(good, ge.ok_line(good) + "\ndryrun_multichip failed", n, True)


def test_dryrun_launch_gate_needs_every_kernel_of_its_path():
    counts = {"fwd": 30, "dkv": 2, "dq": 2, "fwd_seg": 2, "dkv_seg": 2, "dq_seg": 2,
              "int4": 0, "mlp": 0, "dattn": 48}
    chip_smoke.dryrun_launch_gate(counts)
    for key, value in (("dkv_seg", 0), ("dattn", 0), ("int4", 7), ("mlp", 1)):
        with pytest.raises(AssertionError):
            chip_smoke.dryrun_launch_gate({**counts, key: value})


def test_only_entry_is_an_option_that_needs_a_card(capsys):
    """``--only entry`` parses and, without a CUDA device, exits 1 before any
    phase runs (an unknown choice exits 2)."""
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--only", "entry"])
    assert e.value.code == 1 and "no CUDA device" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--only", "entries"])
    assert e.value.code == 2


def test_bench_launch_arithmetic():
    """Phase 24's launches of one bench run at TST_BENCH_STEPS=2,
    TST_BENCH_WARMUP=1, leg by leg: "dots" runs the forward kernel twice a
    step, "attn" and "flash" once; the fold-sequential leg 1 + 5 x 2 one-fold
    steps; each decode leg 4 calls of 16 and 4 of 4 new tokens (72 steps
    after the prefills), K3 on the int4 base's 7 projections a layer."""
    legs, total = chip_smoke.bench_launches_want(2, 1)
    assert legs["fold_parallel"] == {"fwd": 24 * 6, "dkv": 24 * 3, "dq": 24 * 3}
    assert legs["packed"] == {"fwd_seg": 24 * 6, "dkv_seg": 24 * 3, "dq_seg": 24 * 3}
    assert legs["fold_sequential"] == {"fwd": 24 * 22, "dkv": 24 * 11, "dq": 24 * 11}
    assert legs["llama8b_k2"] == {"fwd": 32 * 16, "dkv": 32 * 8, "dq": 32 * 8}
    assert legs["llama8b_k5"] == {"fwd": 32 * 7, "dkv": 32 * 7, "dq": 32 * 7}
    assert legs["llama8b_packed_k2"] == {"fwd_seg": 32 * 16, "dkv_seg": 32 * 8, "dq_seg": 32 * 8}
    assert legs["llama8b_packed_k5"] == {"fwd_seg": 32 * 8, "dkv_seg": 32 * 8, "dq_seg": 32 * 8}
    assert legs["llama8b_int4_decode"] == {"fwd": 32 * 8, "dattn": 32 * 72, "int4": 7 * 32 * 72}
    assert legs["longseq"] == {"fwd": 24 * 6, "dkv": 24 * 6, "dq": 24 * 6}
    assert legs["longseq_32k"] == {"fwd": 24 * 5, "dkv": 24 * 5, "dq": 24 * 5}
    assert legs["decode"] == {"fwd": 24 * 8, "dattn": 24 * 72}
    assert total == {"fwd": 2120, "dkv": 1080, "dq": 1080, "fwd_seg": 912, "dkv_seg": 584,
                     "dq_seg": 584, "int4": 16128, "mlp": 0, "dattn": 4032}
    # the bench's defaults: 15 steps of each 0.5B leg, 1 + 5 x 14 one-fold steps
    legs, _ = chip_smoke.bench_launches_want(12, 3)
    assert legs["fold_parallel"]["fwd"] == 24 * 30 and legs["fold_sequential"]["dq"] == 24 * 71


def _bench_record():
    rec = {"metric": "blind_sft_samples_per_sec_per_chip", "value": 150.5,
           "unit": "samples/s/chip", "vs_baseline": 3.2, "fold_finetunes_per_hour_per_chip": 441.5,
           "backend": "cuda", "n_chips": 1}
    rec.update({key: 1.0 for key in chip_smoke.BENCH_LEG_KEYS})
    rec["compile_cache_hit_fold_parallel"] = True
    return rec


def test_bench_record_gate_needs_the_contract_and_every_leg():
    rec = _bench_record()
    assert chip_smoke.bench_record_gate(json.dumps(rec) + "\n", "[bench] leg: 1 s") == rec
    missing = {key: v for key, v in rec.items() if key != "longseq_32k_tokens_per_s"}
    with pytest.raises(AssertionError, match="longseq_32k_tokens_per_s"):
        chip_smoke.bench_record_gate(json.dumps(missing))
    with pytest.raises(AssertionError, match="skipped"):
        chip_smoke.bench_record_gate(json.dumps(rec), "32k leg skipped: OutOfMemoryError: ...")
    for key, bad in (("backend", "cpu"), ("n_chips", 4), ("value", 0.0), ("vs_baseline", None),
                     ("metric", "samples"), ("fold_finetunes_per_hour_per_chip", True)):
        with pytest.raises(AssertionError, match=key):
            chip_smoke.bench_record_gate(json.dumps({**rec, key: bad}))
    with pytest.raises(AssertionError, match="2 lines"):
        chip_smoke.bench_record_gate(json.dumps(rec) + "\n" + json.dumps(rec))
    with pytest.raises(ValueError, match="strict JSON"):
        chip_smoke.bench_record_gate(json.dumps({**rec, "mfu": float("nan")}))


def test_bench_leg_keys_are_every_card_key_of_the_record():
    """The gate's keys are exactly what the bench writes with every leg run."""
    from tst_torch import bench

    leg = {"samples_per_s": 1.0, "step_ms": 1.0, "compile_s": 1.0, "compile_cache_hit": True,
           "flops_per_step": 1.0, "mfu": 0.5, "hbm_gb": 1.0}
    rec = bench.bench_record(
        "qwen2.5-0.5b", "cuda", leg, {**leg, "fill": 0.9, "pack_len": 1024, "batch_rows": 3},
        1.0, 1.0, {"samples_per_s": 1.0, "mfu": 0.5, "base_hbm_gb": 8.0, "hbm_gb": 9.0,
                   "compile_s": 1.0, "k5_samples_per_s": 1.0, "packed_samples_per_s": 1.0,
                   "k5_packed_samples_per_s": 1.0},
        {"step_tokens_per_s": 1.0, "batch": 32}, {"tokens_per_s": 1.0, "seq_len": 16384},
        {"tokens_per_s": 1.0, "seq_len": 32768},
        {"tokens_per_s": 1.0, "batch": 32, "max_new": 16, "step_tokens_per_s": 1.0})
    contract = {"metric", "value", "unit", "vs_baseline", "fold_finetunes_per_hour_per_chip",
                "backend", "n_chips", "baseline", "headline_config", "model", "k",
                "batch_per_fold", "seq_len"}
    assert set(rec) == contract | set(chip_smoke.BENCH_LEG_KEYS)
    assert chip_smoke.bench_record_gate(json.dumps(rec)) == rec


def test_only_bench_is_an_option_that_needs_a_card(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--only", "bench"])
    assert e.value.code == 1 and "no CUDA device" in capsys.readouterr().err


def test_bench_gates_average_the_batches():
    """Phase 24's gates hold the fold losses and LoRA gradients averaged over
    a leg's first batches to _step_gates' one rule: 1e-3 relative, cosine
    >= 0.999 (0.99 before phase 25; a gradient at cosine ~0.998, which the
    old rule let through, now fails); the lowest cosine is kept under the
    running phase."""
    class Trainer:
        def __init__(self, scale):
            self.scale, self.seen = scale, []

        def batch_loss_and_grads(self, params, lora, tokens, mask, pos, idx, segs=None):
            self.seen.append((int(idx[0, 0]), segs))
            t = float(idx[0, 0])
            loss = torch.tensor([10.0 + t, 12.0 - t], dtype=torch.bfloat16) * self.scale
            return loss, {"q": {"a": torch.full((3,), t + 1, dtype=torch.bfloat16),
                                "b": torch.arange(3.0) * (t + 1)}}

    batches = np.array([[[0], [0]], [[2], [2]], [[4], [4]]])
    kernel = Trainer(1.0)
    loss, grads = chip_smoke.mean_loss_and_grads(kernel, None, None, (None,) * 3, batches, "s")
    assert [t for t, _ in kernel.seen] == [0, 2, 4] and {g for _, g in kernel.seen} == {"s"}
    assert loss.dtype == torch.float32 and loss.tolist() == [12.0, 10.0]
    assert grads["q"]["a"].dtype == torch.float32 and grads["q"]["a"].tolist() == [3.0] * 3
    assert grads["q"]["b"].tolist() == [0.0, 3.0, 6.0]

    plain = (loss, grads)
    assert chip_smoke._step_gates((loss * (1 + 9e-4), grads), plain)[1]
    line, ok = chip_smoke._step_gates((loss * (1 + 1.1e-3), grads), plain)
    assert not ok and "<= 0.001" in line
    flipped = {"q": {"a": grads["q"]["a"], "b": -grads["q"]["b"]}}
    assert not chip_smoke._step_gates((loss, flipped), plain)[1]
    assert chip_smoke.GRAD_COSINE == 0.999
    chip_smoke._PHASE[0] = "test-phase"
    tilt = {"q": {"a": grads["q"]["a"], "b": grads["q"]["b"] + torch.tensor([0.4, 0.0, 0.0])}}
    line, ok = chip_smoke._step_gates((loss, tilt), plain)
    cos = torch.nn.functional.cosine_similarity(tilt["q"]["b"], grads["q"]["b"], dim=0).item()
    assert 0.99 < cos < 0.999 and not ok and ">= 0.999" in line
    assert chip_smoke.LOWEST_COSINE["test-phase"] == pytest.approx(cos, abs=1e-6)
    del chip_smoke.LOWEST_COSINE["test-phase"]
    assert not chip_smoke._step_gates((loss * torch.tensor([1.0, float("nan")]), grads), plain)[1]


def test_gate_adapters_draw_b_from_the_seed():
    """The gates' adapters: the trainer's initial A of ``seed``, B drawn
    nonzero at B_SCALE from seed + 6, the same for the same seed."""
    from tst_torch.models.lora import LoraSpec
    from tst_torch.models.spec import spec_by_name
    from tst_torch.train.sft import FoldTrainer

    spec = spec_by_name("tiny")
    trainer = FoldTrainer(spec, LoraSpec(rank=4, alpha=8.0, dtype=spec.dtype), k=2, lr=1e-4,
                          use_pallas=False)
    cpu = torch.device("cpu")
    one, again, two = (chip_smoke.gate_adapters(trainer, cpu, seed) for seed in (1, 1, 2))
    init = trainer.init_state(torch.Generator(cpu).manual_seed(1))[0]
    for name, ab in one.items():
        torch.testing.assert_close(ab["a"], init[name]["a"], rtol=0, atol=0)
        torch.testing.assert_close(ab["b"], again[name]["b"], rtol=0, atol=0)
        assert ab["b"].dtype == init[name]["b"].dtype and bool((ab["b"] != 0).all())
        assert float(ab["b"].float().abs().max()) < 10 * chip_smoke.B_SCALE
        assert not torch.equal(ab["b"], two[name]["b"])


def test_widths_shapes_cover_every_width():
    """Phase 25's K1 cases hold each of the six widths' (H, KVH, D) with
    KERNEL_SHAPES; S=576 at group 7 and D=128; packed at Qwen2.5-7B's heads;
    the decode attention at the pair's, Qwen2.5-7B's and Llama-3.2-3B's
    layouts; K3's leaves include the shapes the split plan never ran."""
    specs = chip_smoke.widths_specs()
    assert set(specs) == set(chip_smoke.WIDTHS) and len(specs) == 6
    new = chip_smoke.widths_k1_shapes(specs)
    held = {(h, kvh, d) for _, _, h, kvh, d in chip_smoke.KERNEL_SHAPES + new}
    for spec in specs.values():
        assert (spec.n_heads, spec.n_kv_heads, spec.d_head) in held
    assert sorted((h, kvh, d) for _, _, h, kvh, d in new) == [
        (12, 2, 128), (16, 2, 128), (24, 8, 128), (28, 4, 128), (32, 8, 64)]
    assert all(shape[:2] == (32, 512) for shape in new)
    b, s, h, kvh, d = chip_smoke.WIDTHS_ODD
    assert s % 128 == 64 and h // kvh == 7 and d == 128
    assert chip_smoke.WIDTHS_PACKED[1:] == (1024, 28, 4, 128)
    dattn = {(h, kvh, d, t) for _, t, h, kvh, d, _ in chip_smoke.WIDTHS_DATTN}
    assert {(32, 8, 64, 1), (32, 8, 128, chip_smoke.PAIR_GAMMA + 1), (28, 4, 128, 1),
            (24, 8, 128, 1)} == dattn
    seven = chip_smoke.int4_leaves(specs["qwen2.5-7b"])
    assert seven == {"wq": (3584, 3584), "wk": (3584, 512), "wv": (3584, 512),
                     "wo": (3584, 3584), "w_gate": (3584, 18944), "w_up": (3584, 18944),
                     "w_down": (18944, 3584)}
    assert chip_smoke.int4_leaves(specs["qwen2.5-1.5b"], ("wk", "wv", "w_down")) == {
        "wk": (1536, 256), "wv": (1536, 256), "w_down": (8960, 1536)}
    assert chip_smoke.int4_leaves(specs["llama3.2-1b"])["w_down"] == (8192, 2048)
    assert chip_smoke.WIDTHS_INT4_M == (32, 160)


def test_int4_bound_counts_each_leaf():
    """K3's bound: 2·M·K·N operations a leaf; bytes of y (bf16), the packed
    nibbles (half a byte a weight), the f32 scale of each 128-row group and
    the f32 output; the larger time wins."""
    got = chip_smoke.int4_bound([(256, 128), (128, 256)], 32)
    flops = 2 * 32 * 256 * 128 * 2
    nbytes = (32 * 256 * 2 + 256 * 128 // 2 + 2 * 128 * 4 + 32 * 128 * 4
              + 32 * 128 * 2 + 128 * 256 // 2 + 1 * 256 * 4 + 32 * 256 * 4)
    want = max(flops / chip_smoke.PEAK_BF16_FLOPS, nbytes / chip_smoke.PEAK_BYTES_PER_S) * 1e3
    assert got["bound_ms"] == pytest.approx(want) and got["bound_by"] == "bytes"
    big = chip_smoke.int4_bound([(3584, 18944)], 16384)
    assert big["bound_by"] == "operations"
    assert big["bound_ms"] == pytest.approx(2 * 16384 * 3584 * 18944 / 989e12 * 1e3)


def test_split_batches_cut_each_fold_s_rows():
    batches = np.arange(3 * 2 * 16).reshape(3, 2, 16)
    got = chip_smoke.split_batches(batches, 4)
    assert got.shape == (12, 2, 4)
    assert got[0].tolist() == [[0, 1, 2, 3], [16, 17, 18, 19]]
    assert got[3].tolist() == [[12, 13, 14, 15], [28, 29, 30, 31]]
    assert got[4].tolist() == [[32, 33, 34, 35], [48, 49, 50, 51]]
    assert sorted(got.reshape(-1).tolist()) == list(range(96))
    with pytest.raises(ValueError):
        chip_smoke.split_batches(batches, 5)


def test_pair_launch_arithmetic():
    """The pair (int8 target, int4 draft): the prefills one forward a layer
    of each model a chunk; a round gamma + 1 draft steps (K3 on a draft
    layer's 7 projections, decode attention a draft layer) and the target's
    verify chunk (decode attention a target layer, no K3)."""
    want = chip_smoke.pair_launches_want(chunks=2, rounds=30, gamma=4, target_layers=32,
                                         draft_layers=16)
    assert want["fwd"] == 2 * 48 and want["int4"] == 7 * 16 * 5 * 30
    assert want["dattn"] == (16 * 5 + 32) * 30
    assert want["dkv"] == want["dq"] == want["mlp"] == want["fwd_seg"] == 0
    assert chip_smoke.PAIR_GEN[chip_smoke.PAIR_GEN.index("--draft-quantize") + 1] == "int4"
    assert chip_smoke.PAIR_GEN[chip_smoke.PAIR_GEN.index("--gamma") + 1] == "4"


def test_widths_runs_cut_depth_and_restore():
    from tst_torch.models.spec import spec_by_name

    full = spec_by_name("llama3.2-3b")
    with chip_smoke._CutDepth("llama3.2-3b", 4):
        assert spec_by_name("llama3.2-3b") == dataclasses.replace(full, n_layers=4)
    assert spec_by_name("llama3.2-3b") == full
    argv = chip_smoke.widths_argv(chip_smoke.WIDTHS_FULL)
    assert "model.remat=true" in argv and "sft-cvbench-qwen" in argv
    assert "model.remat=true" not in chip_smoke.widths_argv("qwen2.5-1.5b")
    assert "model.tokenizer=byte" in argv


def test_only_widths_is_an_option_that_needs_a_card(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--only", "widths"])
    assert e.value.code == 1 and "no CUDA device" in capsys.readouterr().err


def _probe():
    import importlib.util

    path = Path(__file__).resolve().parent.parent / "scripts" / "torch_probe_spec_decode.py"
    spec = importlib.util.spec_from_file_location("torch_probe_spec_decode", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("gamma", [2, 4])
def test_probe_break_even_alpha_matches_the_formula(gamma):
    """scripts/torch_probe_spec_decode.py: the break-even alpha solves
    sum_{j=1..gamma} alpha^j + 1 = t_round / t_target_step; a round dearer
    than gamma + 1 steps has none; the difference method's step."""
    probe = _probe()
    for alpha in (0.0, 0.25, 0.5, 0.8, 0.95):
        ratio = sum(alpha ** j for j in range(1, gamma + 1)) + 1
        assert probe.expected_commits(alpha, gamma) == pytest.approx(ratio)
        assert probe.break_even_alpha(ratio, gamma) == pytest.approx(alpha, abs=1e-9)
    assert math.isnan(probe.break_even_alpha(gamma + 1.5, gamma))
    assert probe.break_even_alpha(gamma + 1, gamma) == pytest.approx(1.0, abs=1e-9)
    assert probe.step_ms(2.0, 0.8, 12) == pytest.approx(100.0)
    assert probe.step_ms(0.8, 0.8, 12) is None


def test_recorded_ibp_round_is_scored_again_as_it_was(tmp_path):
    """_RecordIbp keeps round 0's last held-out scoring call and puts the
    module back after the run; round0_sx scores it again to the recorded
    probabilities, and in f32 on the same adapters (the rank witness of
    scripts/torch_ibp_rank_witness.py) to ranks near them."""
    from tst_torch import cli
    from tst_torch.debias import ibp as tibp
    from tst_torch.eval.parity import spearman

    before = tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with chip_smoke._RecordIbp() as rounds:
            assert cli.main(["debias-ibp", "--platform", "cpu", "--bench", "synthetic:0.5",
                             "--k", "2", "--set", "data.n=32", "--set", "data.max_len=128",
                             "--set", "model.name=tiny", "--set", "model.dtype=bfloat16",
                             "--set", "optim.batch_size=4", "--set", "optim.epochs=1",
                             "--set", "ibp.rounds=1", "--set", "ibp.stop_epsilon=-1",
                             "--set", "rf.cross_check=false", "--out", str(tmp_path)]) == 0
        assert (tibp._SftRoundRunner.run_round, tibp.score_heldout_mcq) == before
        assert [r["round"] for r in rounds] == [0] and "score" in rounds[0]
        s, probs, mcq = chip_smoke.round0_sx(rounds)
        assert probs is rounds[0]["score"][2] and mcq.sum() == len(s) > 4
        s_again, probs_again, _ = chip_smoke.round0_sx(rounds, use_pallas=False)
        np.testing.assert_array_equal(probs_again, probs)
        s32, probs32, _ = chip_smoke.round0_sx(rounds, f32=True)
        assert probs32.dtype == probs.dtype and not np.array_equal(probs32, probs)
        assert spearman(s32, s) > 0.9
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_launch_arithmetic(n):
    """One pass of the ring's K1 route: in one process over n blocks, n
    causal (the diagonals) and n(n-1)/2 non-causal (the past blocks)
    launches; on a mesh rank idx one causal and idx non-causal; without
    causal n non-causal a Q block."""
    assert chip_smoke.ring_launches_want(n) == {"causal": n, "full": n * (n - 1) // 2}
    for idx in range(n):
        assert chip_smoke.ring_launches_want(n, [idx]) == {"causal": 1, "full": idx}
    assert sum(chip_smoke.ring_launches_want(n, [i])["full"] for i in range(n)) == (
        chip_smoke.ring_launches_want(n)["full"])
    assert chip_smoke.ring_launches_want(n, causal=False) == {"causal": 0, "full": n * n}
    assert chip_smoke.ring_launches_want(n, [1], causal=False) == {"causal": 0, "full": n}


def test_ring_launch_gate_counts_each_kernel():
    want = chip_smoke.ring_launches_want(4)
    good = {"causal": {"fwd": 4, "dkv": 4, "dq": 4}, "full": {"fwd": 6, "dkv": 6, "dq": 6}}
    chip_smoke.check_ring_launches(good, 4, True, 0)
    assert want == {"causal": 4, "full": 6}
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_ring_launches({**good, "full": {"fwd": 10, "dkv": 6, "dq": 6}}, 4,
                                       True, 0)
    with pytest.raises(AssertionError, match="plain partials"):
        chip_smoke.check_ring_launches(good, 4, True, 3)
    none = {kind: {"fwd": 0, "dkv": 0, "dq": 0} for kind in ("causal", "full")}
    chip_smoke.check_ring_launches(none, 4, False, 24)
    with pytest.raises(AssertionError):
        chip_smoke.check_ring_launches(good, 4, False, 24)


@pytest.mark.parametrize("shape,ms", [((10, 4096, 14, 2, 64), (0.608, 1.216, 0.912)),
                                      ((1, 4096, 32, 8, 128), (0.278, 0.556, 0.417))])
def test_non_causal_bounds_count_every_pair(shape, ms):
    """Without the causal mask every (query, key) pair is counted: 4·B·H·S²·D
    operations forward (twice the causal count at large S), 8 and 6 times
    for dK/dV and dQ, over 989 TFLOP/s: operations bind."""
    b, s, h, kvh, d = shape
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, kvh, d, dtype=torch.bfloat16, device="meta")
    full = chip_smoke._attention_bounds(q, k, causal=False)
    causal = chip_smoke._attention_bounds(q, k)
    for key, want in zip(("fwd", "dkv", "dq"), ms):
        assert full[key]["bound_by"] == "operations"
        assert full[key]["bound_ms"] == pytest.approx(want, rel=2e-3)
        assert full[key]["bound_ms"] == pytest.approx(
            2 * causal[key]["bound_ms"] * s / (s + 1), rel=1e-9)
    assert full["fwd"]["bound_ms"] == pytest.approx(4 * b * h * s * s * d / 989e12 * 1e3)


def test_forward_gate_sees_a_scaled_o_at_the_ring_block():
    """Phase 5b's forward gate at the ring's block (q [10, 4096, 14, 64],
    inputs as _randn draws them; here one batch row and its first 512
    queries, which see the same 4096 keys): a non-causal row averages 4096
    values, so max|o| is ~0.03 and O_TOL alone passes o·0.8; the gate's
    relative part refuses it, and passes o rounded to bf16 as the kernel
    writes it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(0)
        q = chip_smoke._randn(rng, (1, 512, 14, 64), "cpu")
        k, v = (chip_smoke._randn(rng, (1, 4096, 2, 64), "cpu") for _ in range(2))
        s = torch.einsum("bqkgd,bskd->bkgqs", q.float().reshape(1, 512, 2, 7, 64),
                         k.float()) / math.sqrt(64)
        lse = torch.logsumexp(s, -1).reshape(1, 14, 512)
        o = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, -1), v.float()).reshape(
            1, 512, 14, 64)
    finally:
        torch.set_num_threads(threads)
    got, ok = chip_smoke.forward_gate(o.bfloat16(), lse, o, lse)
    assert ok and got["o_rel"] < chip_smoke.O_REL_TOL / 4
    got, ok = chip_smoke.forward_gate(o * 0.8, lse, o, lse)
    assert got["o_err"] < chip_smoke.O_TOL and got["lse_err"] == 0.0
    assert not ok and got["o_rel"] == pytest.approx(0.2, rel=1e-4)
    _, ok = chip_smoke.forward_gate(o.masked_fill(o > 0.02, float("nan")), lse, o, lse)
    assert not ok


def test_ring_gate_sees_late_rows_scaled():
    """The ring's gate (phase 21c): a causal output whose rows past the
    first block are 0.8 of the reference differs from it by less than
    O_TOL there (those rows average thousands of keys), and is refused by
    the output's cosine; the reference itself passes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rng = np.random.default_rng(1)
        n = 4096
        q, k, v = (chip_smoke._randn(rng, (1, n, 1, 64), "cpu") for _ in range(3))
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(64)
        s = s.masked_fill(~torch.ones(n, n, dtype=torch.bool).tril(), float("-inf"))
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())
    finally:
        torch.set_num_threads(threads)
    grads = [q.float(), k.float(), v.float()]
    read = chip_smoke.ring_gate(o, grads, o, grads, "the reference")
    assert read["o_cosine"] == pytest.approx(1.0, abs=1e-4)  # f32 sums
    bad = o.clone()
    bad[:, n // 4:] *= 0.8
    assert (bad - o).abs().max().item() < chip_smoke.O_TOL
    with pytest.raises(AssertionError, match="the ring disagrees"):
        chip_smoke.ring_gate(bad, grads, o, grads, "late rows scaled")
