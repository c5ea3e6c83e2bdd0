"""Flash-attention backward of the PyTorch port: the autograd Function, the
plain backward, and (on a card) the dK/dV and dQ kernels.

On the CPU, ``flash_attention_backward_reference`` is held to torch autograd
of ``masked_attention`` and to ``jax.grad`` of the JAX package's Pallas
kernel (interpret mode, as tests/test_flash_attention.py runs it) on the same
numpy inputs, f32, GQA 4:2, D=64. The CUDA kernels run only on a card:
``test_backward_kernels_match_reference_on_card`` is marked ``cuda`` and
skips without one. jax is imported inside the tests that use it, so the card
test also collects where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_bwd.py
"""

import numpy as np
import pytest
import torch

import tst_torch.kernels.flash_attention as tfa


def _inputs(b, s, h, kvh, d, seed=0, scale=0.5):
    """q, k, v and an upstream gradient do, f32 numpy."""
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * scale).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)))


def _causal(s):
    return torch.ones(s, s, dtype=torch.bool).tril()


def test_function_carries_gradients_on_cpu():
    """The fault a ctypes call into empty_like outputs had on the card: o
    without a grad_fn. Every device now goes through one autograd Function,
    whose backward node o carries; lse is not differentiable."""
    q, k, v, do = map(torch.from_numpy, _inputs(1, 128, 4, 2, 64))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    o, lse = tfa.flash_attention(*leaves)
    assert o.grad_fn is not None
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    assert not lse.requires_grad
    o.backward(do)
    assert all(t.grad is not None and t.grad.abs().max() > 0 for t in leaves)


@pytest.mark.parametrize("s", [128, 256])
def test_backward_reference_matches_autograd(s):
    """f32: the plain backward against autograd of the dense attention, atol
    1e-4 (f32 sums in another order)."""
    q, k, v, do = map(torch.from_numpy, _inputs(2, s, 4, 2, 64, seed=s))
    o, lse = tfa.flash_attention_reference(q, k, v)
    got = tfa.flash_attention_backward_reference(q, k, v, o, lse, do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.masked_attention(*leaves, _causal(s))[0].backward(do)
    for g, leaf in zip(got, leaves):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), atol=1e-4)


@pytest.mark.parametrize("s", [128, 256])
def test_backward_reference_matches_jax(monkeypatch, s):
    """f32: the plain backward against jax.grad of the JAX package's flash
    attention (its Pallas kernels in interpret mode), atol 1e-4."""
    import jax
    import jax.numpy as jnp

    import tst.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "_INTERPRET", True)
    q, k, v, do = _inputs(1, s, 4, 2, 64, seed=s + 1)

    def loss(q_, k_, v_):
        return jnp.sum(fa.flash_attention(q_, k_, v_, causal=True) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_reference(tq, tk, tv)
    got = tfa.flash_attention_backward_reference(tq, tk, tv, o, lse, tdo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("d", [64, 128])
def test_non_causal_backward_reference_matches_jax(monkeypatch, s, d):
    """causal=False, f32, GQA 4:2 at both kernel head dims: the plain
    backward against jax.grad of the JAX package's flash attention with
    causal=False (its Pallas kernels in interpret mode), atol 1e-4; and
    through the autograd Function on CPU tensors, the same gradients."""
    import jax
    import jax.numpy as jnp

    import tst.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "_INTERPRET", True)
    q, k, v, do = _inputs(1, s, 4, 2, d, seed=s + d + 2)

    def loss(q_, k_, v_):
        return jnp.sum(fa.flash_attention(q_, k_, v_, causal=False) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_attention_reference(tq, tk, tv, causal=False)
    got = tfa.flash_attention_backward_reference(tq, tk, tv, o, lse, tdo, causal=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    tfa.flash_attention(*leaves, causal=False)[0].backward(tdo)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_from_row_stats_is_the_reference(causal):
    """The plain backward from explicit lse and di (what the kernels and the
    ring take) is the plain backward of o, bit for bit, when di = Σ o·do of
    that o."""
    q, k, v, do = map(torch.from_numpy, _inputs(2, 128, 4, 2, 64, seed=7))
    o, lse = tfa.flash_attention_reference(q, k, v, causal=causal)
    di = tfa.backward_row_stat(o, do)
    want = tfa.flash_attention_backward_reference(q, k, v, o, lse, do, causal)
    got = tfa.attention_backward_reference(q, k, v, lse, di, do, causal)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the statistics are used as given: another di moves dq and dk, not dv
    other = tfa.attention_backward_reference(q, k, v, lse, di + 0.5, do, causal)
    assert not torch.allclose(other[0], want[0]) and torch.equal(other[2], want[2])


def test_cpu_function_backward_is_the_plain_backward():
    """On CPU tensors the Function's backward is the plain backward, and no
    kernel is launched."""
    q, k, v, do = map(torch.from_numpy, _inputs(2, 128, 4, 2, 64, seed=3))
    before = (tfa.LAUNCHES, tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tfa.flash_attention(*leaves)
    o.backward(do)
    want = tfa.flash_attention_backward_reference(q, k, v, o.detach(), lse, do)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    assert (tfa.LAUNCHES, tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) == before


def test_backward_wrapper_takes_no_cpu_tensors():
    """The kernel wrapper has no fallback: a CPU tensor is refused."""
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _inputs(1, 128, 4, 2, 64))
    lse = torch.zeros(1, 4, 128)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfa.flash_attention_backward(q, k, v, lse, lse, do)


@pytest.mark.parametrize("change,msg", [
    ({"lse": torch.zeros(1, 4, 64)}, "lse"),
    ({"lse": torch.zeros(1, 4, 128, dtype=torch.float64)}, "float32"),
    ({"do": torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16)}, "do"),
    ({"do": torch.zeros(1, 128, 4, 64)}, "bfloat16"),
    ({"di": torch.zeros(1, 4, 64)}, "di"),
    ({"di": torch.zeros(1, 4, 128, dtype=torch.bfloat16)}, "float32"),
    ({"causal": False, "lse": torch.zeros(1, 4, 64)}, "lse"),
])
def test_backward_argument_checks(change, msg):
    args = {"q": torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16),
            "k": torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16),
            "v": torch.zeros(1, 128, 2, 64, dtype=torch.bfloat16),
            "lse": torch.zeros(1, 4, 128),
            "di": torch.zeros(1, 4, 128),
            "do": torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16)}
    args.update(change)
    with pytest.raises(ValueError, match=msg):
        tfa.check_backward_args(**args)


#: the train step's attention call (2 folds x 16 rows, Qwen2.5-0.5B heads),
#: Llama-3-8B heads at D=128, a 128-token case; S=576, where a 128-key tile
#: ends past S; the other model widths' head layouts (12/2, 16/2, 28/4 and
#: 24/8 at D=128, 32/8 at D=64) and S=576 at Qwen2.5-7B's group of 7
CARD_SHAPES = [(32, 512, 14, 2, 64), (2, 2048, 32, 8, 128), (4, 128, 14, 2, 64),
               (2, 576, 14, 2, 64), (4, 512, 12, 2, 128), (4, 512, 16, 2, 128),
               (4, 512, 28, 4, 128), (4, 512, 24, 8, 128), (4, 512, 32, 8, 64),
               (2, 576, 28, 4, 128)]


@pytest.mark.cuda
def test_backward_kernels_match_reference_on_card():
    """bf16 on the card. Each of dq, dk, dv from the kernels is held to the
    f32 plain backward on the same o and lse, and the gradients through the
    Function to autograd of the plain attention, at max|d - ref| <=
    2e-2·max|ref| (P and dS are rounded to bf16 as operands; dk and dv sum
    over a GQA group and up to S rows). Gradients are nonzero, and the
    Function's backward launches each kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, s, h, kvh, d in CARD_SHAPES:
        q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                       for a in _inputs(b, s, h, kvh, d, seed=s))
        o, lse = tfa.flash_attention(q, k, v)
        got = tfa.flash_attention_backward(q, k, v, lse, tfa.backward_row_stat(o, do), do)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float())
        for g, w in zip(got, want):
            assert g.abs().max().item() > 0
            assert (g.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()

        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ)
        tfa.flash_attention(*leaves)[0].backward(do)
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES_BWD_DKV, tfa.LAUNCHES_BWD_DQ) == (before[0] + 1, before[1] + 1)
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").tril()
        tfa.masked_attention(*plain, mask)[0].backward(do)
        for a, p in zip(leaves, plain):
            assert (a.grad.float() - p.grad.float()).abs().max().item() <= (
                2e-2 * p.grad.float().abs().max().item())
    bad = torch.zeros(1, 100, 2, 64, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        stat = torch.zeros(1, 2, 100, device="cuda")
        tfa.flash_attention_backward(bad, bad, bad, stat, stat, bad)


#: the non-causal kernels at the train step's call, Llama-3-8B heads, a
#: 128-token case, S=576 at both head dims, the ring's block at the long
#: preset's heads (4 blocks of 4096)
FULL_CARD_SHAPES = [(32, 512, 14, 2, 64), (2, 2048, 32, 8, 128), (4, 128, 14, 2, 64),
                    (2, 576, 14, 2, 64), (2, 576, 28, 4, 128), (2, 4096, 14, 2, 64)]


@pytest.mark.cuda
def test_non_causal_backward_kernels_match_reference_on_card():
    """causal=False in bf16 on the card, at the causal kernels' rule (each
    of dq, dk, dv within 2e-2·max|ref| of the f32 plain backward); the
    Function's backward launches each non-causal kernel once and gives the
    kernels' gradients; a second call bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, s, h, kvh, d in FULL_CARD_SHAPES:
        q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                       for a in _inputs(b, s, h, kvh, d, seed=s + 3))
        o, lse = tfa.flash_attention(q, k, v, causal=False)
        di = tfa.backward_row_stat(o, do)
        got = tfa.flash_attention_backward(q, k, v, lse, di, do, causal=False)
        again = tfa.flash_attention_backward(q, k, v, lse, di, do, causal=False)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), False)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a) and g.abs().max().item() > 0
            assert (g.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_FULL_BWD_DKV, tfa.LAUNCHES_FULL_BWD_DQ)
        tfa.flash_attention(*leaves, causal=False)[0].backward(do)
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES_FULL_BWD_DKV, tfa.LAUNCHES_FULL_BWD_DQ) == (before[0] + 1,
                                                                       before[1] + 1)
        for leaf, g in zip(leaves, got):
            assert torch.equal(leaf.grad, g)


#: dQ on the card: (B, S, H, KVH, D) at S = 64, 576 and 1088 (one 128-row
#: tile past S, odd tile counts), GQA groups of 7 and 4, both head dims
DQ_CARD_SHAPES = [(3, 64, 14, 2, 64), (2, 576, 14, 2, 64), (2, 1088, 28, 4, 128),
                  (2, 64, 32, 8, 128), (2, 576, 32, 8, 128), (2, 1088, 14, 2, 64)]


@pytest.mark.cuda
def test_dq_kernels_match_reference_on_card():
    """dQ causal, non-causal and segmented (the persistent kernel where the C
    entries take it, the 64-row one for packed rows and non-causal at D=128)
    within 2e-2·max|ref| of the f32 plain backward on the same o and lse,
    bit-equal on a second call, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, s, h, kvh, d in DQ_CARD_SHAPES:
        q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                       for a in _inputs(b, s, h, kvh, d, seed=s + d))
        starts = torch.tensor([[0, s // 3, s // 3 + 37] + [tfa.SEG_PAD] * 5] * b,
                              dtype=torch.int32, device="cuda")
        for causal, seg in ((True, None), (False, None), (True, starts)):
            o, lse = tfa.flash_attention(q, k, v, causal=causal, seg_starts=seg)
            di = tfa.backward_row_stat(o, do)
            want = tfa.flash_attention_backward_reference(
                q.float(), k.float(), v.float(), o.float(), lse, do.float(), causal,
                seg_starts=seg)[0]
            kseg = tfa.kernel_seg_starts(seg, q, causal)
            counts = (tfa.LAUNCHES_BWD_DQ, tfa.LAUNCHES_SEG_BWD_DQ, tfa.LAUNCHES_FULL_BWD_DQ)
            got = tfa._launch_bwd_dq(q, k, v, do, lse, di, kseg, causal)
            again = tfa._launch_bwd_dq(q, k, v, do, lse, di, kseg, causal)
            torch.cuda.synchronize()
            after = (tfa.LAUNCHES_BWD_DQ, tfa.LAUNCHES_SEG_BWD_DQ, tfa.LAUNCHES_FULL_BWD_DQ)
            assert sum(after) - sum(counts) == 2
            assert torch.equal(got, again), (b, s, h, d, causal, seg is not None)
            assert got.abs().max().item() > 0
            assert (got.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()
