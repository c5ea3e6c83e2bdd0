"""Flash-attention parity for the PyTorch port (tst_torch.kernels.flash_attention).

On the CPU the plain version, ``flash_attention_reference``, is held to the
JAX package's Pallas kernel (interpret mode, as tests/test_flash_attention.py
runs it) and to ``mha_reference`` on the same numpy inputs. The CUDA kernel
itself runs only on a card: ``test_kernel_matches_reference_on_card`` is
marked ``cuda`` and skips without one. jax is imported inside the fixtures,
so the card test also collects where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

import tst_torch.kernels.flash_attention as tfa
from tst_torch.kernels import _build


@pytest.fixture
def jax_fa(monkeypatch):
    import tst.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "_INTERPRET", True)
    return fa


def _qkv(b, s, h, kvh, d, seed=0, scale=0.3):
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * scale).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d)))


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("d", [32, 64])
def test_reference_matches_jax(jax_fa, s, d):
    """f32, GQA 8:2. o atol 2e-5 (the JAX suite's own kernel-vs-reference
    bound: f32 sums in another order); lse atol 1e-5 against
    jax.nn.logsumexp of the masked reference logits."""
    import jax
    import jax.numpy as jnp

    q, k, v = _qkv(2, s, 8, 2, d)
    o, lse = tfa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_pallas = np.asarray(jax_fa.flash_attention(jq, jk, jv, causal=True))
    o_dense = np.asarray(jax_fa.mha_reference(jq, jk, jv, causal=True))
    np.testing.assert_allclose(o.numpy(), o_pallas, atol=2e-5)
    np.testing.assert_allclose(o.numpy(), o_dense, atol=2e-5)

    qg = jq.reshape(2, s, 2, 4, d)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", qg, jk) / np.sqrt(d)
    logits = jnp.where(jnp.tril(jnp.ones((s, s), bool)), logits, -1e30)
    lse_ref = np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(2, 8, s)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_non_causal_reference_matches_jax(jax_fa, s, d):
    """causal=False, f32, GQA 8:2 at both kernel head dims: o against the
    JAX package's Pallas kernel (interpret mode) and ``mha_reference`` at
    atol 2e-5, lse against jax.nn.logsumexp of the unmasked logits at atol
    1e-5, as the causal case."""
    import jax
    import jax.numpy as jnp

    q, k, v = _qkv(2, s, 8, 2, d, seed=s + d)
    o, lse = tfa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)), causal=False)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    o_pallas = np.asarray(jax_fa.flash_attention(jq, jk, jv, causal=False))
    o_dense = np.asarray(jax_fa.mha_reference(jq, jk, jv, causal=False))
    np.testing.assert_allclose(o.numpy(), o_pallas, atol=2e-5)
    np.testing.assert_allclose(o.numpy(), o_dense, atol=2e-5)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", jq.reshape(2, s, 2, 4, d), jk) / np.sqrt(d)
    lse_ref = np.asarray(jax.nn.logsumexp(logits, axis=-1)).reshape(2, 8, s)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5)


def test_non_causal_cpu_wrapper_takes_plain_version_without_launch():
    """causal=False on CPU tensors: the plain version through the operator,
    no launch of any kernel; every key visible (the last query's o differs
    from the causal one only through the keys after it)."""
    q, k, v = map(torch.from_numpy, _qkv(1, 128, 4, 2, 64, seed=5))
    before = (tfa.LAUNCHES, tfa.LAUNCHES_FULL)
    o, lse = tfa.flash_attention(q, k, v, causal=False)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=False)
    assert (tfa.LAUNCHES, tfa.LAUNCHES_FULL) == before
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)
    o_causal, _ = tfa.flash_attention(q, k, v)
    assert torch.allclose(o[:, -1], o_causal[:, -1], atol=1e-6)
    assert not torch.allclose(o[:, 0], o_causal[:, 0], atol=1e-3)


def test_cpu_wrapper_takes_plain_version_without_launch():
    q, k, v = map(torch.from_numpy, _qkv(1, 128, 4, 2, 64))
    before = tfa.LAUNCHES
    o, lse = tfa.flash_attention(q, k, v)
    o_ref, lse_ref = tfa.flash_attention_reference(q, k, v)
    assert tfa.LAUNCHES == before
    assert torch.equal(o, o_ref) and torch.equal(lse, lse_ref)


@pytest.mark.parametrize("shape,dtype,causal,msg", [
    ((1, 100, 4, 2, 64), torch.bfloat16, True, "multiple of 64"),
    ((1, 128, 4, 2, 32), torch.bfloat16, True, "head dim"),
    ((1, 128, 6, 4, 64), torch.bfloat16, True, "not a multiple"),
    ((1, 128, 4, 2, 64), torch.float32, True, "bfloat16"),
    ((1, 128, 4, 2, 64), torch.bfloat16, False, "needs causal=True"),
])
def test_kernel_argument_checks(shape, dtype, causal, msg):
    """What the CUDA wrapper checks before a launch, in its order: the
    operands, then packed rows' starts, which need causal=True (the
    reference's rule, tst/kernels/flash_attention.py:1257)."""
    b, s, h, kvh, d = shape
    q = torch.zeros(b, s, h, d, dtype=dtype)
    kv = torch.zeros(b, s, kvh, d, dtype=dtype)
    with pytest.raises(ValueError, match=msg):
        tfa.check_kernel_args(q, kv, kv, causal=causal)
        tfa.kernel_seg_starts(torch.zeros(b, 1, dtype=torch.int32), q, causal)


def test_kernel_args_take_causal_false():
    """The non-causal kernels take what the causal ones take."""
    q = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16)
    kv = torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)
    tfa.check_kernel_args(q, kv, kv, causal=False)
    assert tfa.kernel_seg_starts(None, q, causal=False) is None


def test_nvcc_command_targets_sm90a(tmp_path):
    cmd = _build.nvcc_command("nvcc", _build.sources(), tmp_path / "lib.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[cmd.index("arch=compute_90a,code=sm_90a") - 1] == "-gencode"
    assert "-shared" in cmd and "-O3" in cmd
    assert [p.name for p in _build.sources()] == ["decode_attention.cu",
                                                  "flash_attention_bwd.cu",
                                                  "flash_attention_fwd.cu", "fused_mlp.cu",
                                                  "int4_matmul.cu"]
    assert "-c" in _build.nvcc_command("nvcc", _build.sources()[:1], tmp_path / "a.o",
                                       compile_only=True)
    assert _build.library_path().parent == _build.BUILD_DIR


#: shapes of chip_smoke.py's kernel phase: the slice's own (Qwen2.5-0.5B
#: heads, 32-row scorer chunk, S=512), Llama-3-8B heads, a 128-token case and
#: one tile (S=64) at both head dims; S=576, where a 128-row tile ends past S;
#: the other model widths' head layouts (Qwen2.5-1.5B 12/2, -3B 16/2, -7B
#: 28/4, Llama-3.2-3B 24/8 at D=128, Llama-3.2-1B 32/8 at D=64), and S=576
#: at Qwen2.5-7B's group of 7
CARD_SHAPES = [(32, 512, 14, 2, 64), (2, 2048, 32, 8, 128), (4, 128, 14, 2, 64),
               (3, 64, 14, 2, 64), (2, 64, 8, 2, 128), (2, 576, 8, 2, 128),
               (4, 512, 12, 2, 128), (4, 512, 16, 2, 128), (4, 512, 28, 4, 128),
               (4, 512, 24, 8, 128), (4, 512, 32, 8, 64), (2, 576, 28, 4, 128)]


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """bf16 on the card: o max|Δ| <= 2e-2 (one bf16 rounding of P and of o
    at |o| < 2) and lse max|Δ| <= 1e-3 (f32 sums in another order); a
    second call is bit-equal (one fixed summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, s, h, kvh, d in CARD_SHAPES:
        q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in _qkv(b, s, h, kvh, d, seed=s, scale=0.5))
        before = tfa.LAUNCHES
        o, lse = tfa.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert tfa.LAUNCHES == before + 1
        o2, lse2 = tfa.flash_attention(q, k, v)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v)
        assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
        assert (lse - lse_ref).abs().max().item() <= 1e-3
    bad = torch.zeros(1, 100, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tfa.flash_attention(bad, bad, bad)


#: the non-causal kernels' shapes: a 128-token case, one tile (S=64) at both
#: head dims, S=576 at both (a last 128-key tile past S), the ring's block at
#: the long preset's heads (4 blocks of 4096) and at Llama-3-8B's
FULL_CARD_SHAPES = [(4, 128, 14, 2, 64), (3, 64, 14, 2, 64), (2, 64, 8, 2, 128),
                    (2, 576, 14, 2, 64), (2, 576, 8, 2, 128), (2, 4096, 14, 2, 64),
                    (1, 4096, 32, 8, 128)]


@pytest.mark.cuda
def test_non_causal_kernel_matches_reference_on_card():
    """causal=False in bf16 on the card, at the causal kernel's tolerances
    (o 2e-2, lse 1e-3), one launch of the non-causal forward a call and a
    bit-equal second call; seg_starts with causal=False raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, s, h, kvh, d in FULL_CARD_SHAPES:
        q, k, v = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                   for a in _qkv(b, s, h, kvh, d, seed=s + 1, scale=0.5))
        before = (tfa.LAUNCHES, tfa.LAUNCHES_FULL)
        o, lse = tfa.flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES, tfa.LAUNCHES_FULL) == (before[0], before[1] + 1)
        o2, lse2 = tfa.flash_attention(q, k, v, causal=False)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, causal=False)
        assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
        assert (lse - lse_ref).abs().max().item() <= 1e-3
    seg = torch.zeros(b, 1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="causal=True"):
        tfa.flash_attention(q, k, v, causal=False, seg_starts=seg)
