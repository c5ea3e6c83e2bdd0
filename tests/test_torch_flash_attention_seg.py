"""Segment-masked flash attention of the PyTorch port (packed rows).

On the CPU, the plain segmented forward and backward are held to the JAX
package's ``mha_reference(seg_starts=)``, to its ``flash_attention(seg_starts=)``
(Pallas interpret mode, as tests/test_packing.py runs it: the one-shot
dispatch, and the chunked segment-sparse K2 bodies with ``SEG_SPARSE_MIN_S``,
``SEG_BLOCK_Q`` and ``SEG_CHUNK`` monkeypatched down) and to ``jax.grad`` of
it, in f32 at atol 1e-5. Cases: starts inside 64-row tiles (offsets 1, 63,
64, 65), a row of all SEG_PAD, a single segment, a first start after 0. The
segmented CUDA kernels run only on a card: the ``cuda``-marked test skips
without one. jax is imported inside the tests that use it, so the card test
also collects where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_flash_attention_seg.py
"""

import numpy as np
import pytest
import torch

import tst_torch.kernels.flash_attention as tfa

PAD = tfa.SEG_PAD


def seg_rows(b, s, seed=0):
    """int32 [b, MAX_SEGS] starts: starts inside 64-row tiles (1, 63, 64, 65
    and near the end), all SEG_PAD, one segment, a first start after 0, then
    random ascending layouts."""
    fixed = [sorted({0, 1, 63, 64, 65, s // 2 + 1, max(s - 65, 0), s - 1}),
             [], [0], [7, min(70, s - 1)]]
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(b):
        if i < len(fixed):
            starts = fixed[i]
        else:
            n = int(rng.integers(1, tfa.MAX_SEGS + 1))
            starts = [0] + sorted(rng.choice(np.arange(1, s), n - 1, replace=False).tolist())
        starts = starts[:tfa.MAX_SEGS]
        rows.append(starts + [PAD] * (tfa.MAX_SEGS - len(starts)))
    return np.asarray(rows, np.int32)


def _inputs(b, s, h, kvh, d, seed=0, scale=0.5):
    """q, k, v and an upstream gradient do, f32 numpy."""
    rng = np.random.default_rng(seed)
    return tuple((rng.normal(size=shape) * scale).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)))


@pytest.mark.parametrize("s", [64, 130, 256])
def test_segment_starts_and_mask_match_reference(s):
    import jax.numpy as jnp

    import tst.kernels.flash_attention as fa

    seg = seg_rows(6, max(s, 128), seed=s)[:, :5]  # fewer columns than MAX_SEGS
    got_start = tfa.segment_starts_per_pos(torch.from_numpy(seg), s)
    got_mask = tfa.segment_mask(torch.from_numpy(seg), s)
    np.testing.assert_array_equal(got_start.numpy(),
                                  np.asarray(fa.segment_starts_per_pos(jnp.asarray(seg), s)))
    np.testing.assert_array_equal(got_mask.numpy(),
                                  np.asarray(fa.segment_mask(jnp.asarray(seg), s)))


@pytest.mark.parametrize("s,d", [(128, 64), (256, 32)])
def test_plain_forward_matches_reference(monkeypatch, s, d):
    """f32, GQA 4:2: o against mha_reference and the Pallas kernels (the
    one-shot segmented dispatch), atol 1e-5; lse against logsumexp of the
    reference's masked logits."""
    import jax
    import jax.numpy as jnp

    import tst.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "_INTERPRET", True)
    q, k, v, _ = _inputs(4, s, 4, 2, d, seed=s)
    seg = seg_rows(4, s, seed=s)
    o, lse = tfa.flash_attention_reference(*map(torch.from_numpy, (q, k, v)),
                                           seg_starts=torch.from_numpy(seg))
    jq, jk, jv, js = map(jnp.asarray, (q, k, v, seg))
    np.testing.assert_allclose(o.numpy(), np.asarray(fa.mha_reference(jq, jk, jv, seg_starts=js)),
                               atol=1e-5)
    np.testing.assert_allclose(o.numpy(), np.asarray(fa.flash_attention(jq, jk, jv, seg_starts=js)),
                               atol=1e-5)
    logits = jnp.einsum("bqkgd,bskd->bkgqs", jq.reshape(4, s, 2, 2, d), jk) / np.sqrt(d)
    logits = jnp.where(fa.segment_mask(js, s)[:, None, None], logits, -1e30)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax.nn.logsumexp(logits, -1)).reshape(
        4, 4, s), atol=1e-5)


def _jax_grads(fa, q, k, v, do, seg):
    import jax
    import jax.numpy as jnp

    def loss(q_, k_, v_):
        o = fa.flash_attention(q_, k_, v_, causal=True, seg_starts=jnp.asarray(seg))
        return jnp.sum(o * jnp.asarray(do))

    out = fa.flash_attention(*map(jnp.asarray, (q, k, v)), seg_starts=jnp.asarray(seg))
    return np.asarray(out), jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("chunked", [False, True], ids=["oneshot", "chunked-K2"])
def test_plain_backward_matches_jax_grad(monkeypatch, chunked):
    """f32: the plain segmented forward and backward against the Pallas
    kernels and jax.grad through them (interpret mode), atol 1e-5. chunked:
    the segment-sparse K2 bodies (`_fwd_kernel_oneshot_chunked`,
    `_bwd_fused_chunked_kernel`), reached at S=256 by lowering their
    dispatch threshold and tiles as tests/test_packing.py does."""
    import tst.kernels.flash_attention as fa

    monkeypatch.setattr(fa, "_INTERPRET", True)
    if chunked:
        monkeypatch.setattr(fa, "SEG_SPARSE_MIN_S", 256)
        monkeypatch.setattr(fa, "SEG_BLOCK_Q", 128)
        monkeypatch.setattr(fa, "SEG_CHUNK", 64)
    q, k, v, do = _inputs(4, 256, 4, 2, 32, seed=7, scale=0.3)
    seg = seg_rows(4, 256, seed=3)
    want_o, want = _jax_grads(fa, q, k, v, do, seg)
    tq, tk, tv, tdo, tseg = map(torch.from_numpy, (q, k, v, do, seg))
    o, lse = tfa.flash_attention_reference(tq, tk, tv, seg_starts=tseg)
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5)
    got = tfa.flash_attention_backward_reference(tq, tk, tv, o, lse, tdo, seg_starts=tseg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_function_backward_is_autograd_of_masked_attention():
    """On CPU tensors the Function's segmented backward is the plain one and
    equals autograd of the dense masked attention (atol 1e-5); no kernel
    launches."""
    q, k, v, do = map(torch.from_numpy, _inputs(4, 128, 4, 2, 64, seed=5))
    seg = torch.from_numpy(seg_rows(4, 128, seed=5))
    counts = (tfa.LAUNCHES_SEG, tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tfa.flash_attention(*leaves, seg_starts=seg)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward" and not lse.requires_grad
    o.backward(do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    tfa.masked_attention(*plain, tfa.segment_mask(seg, 128))[0].backward(do)
    for a, p in zip(leaves, plain):
        np.testing.assert_allclose(a.grad.numpy(), p.grad.numpy(), atol=1e-5)
    assert (tfa.LAUNCHES_SEG, tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ) == counts


def test_single_segment_is_plain_causal():
    """A row of one segment at 0, and a row of all SEG_PAD, are plain causal
    attention."""
    q, k, v, _ = map(torch.from_numpy, _inputs(2, 128, 4, 2, 64, seed=2))
    seg = torch.tensor([[0] + [PAD] * 7, [PAD] * 8], dtype=torch.int32)
    got = tfa.flash_attention_reference(q, k, v, seg_starts=seg)
    want = tfa.flash_attention_reference(q, k, v)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seg,causal,msg", [
    (torch.zeros(2, 9, dtype=torch.int32), True, "MAX_SEGS"),
    (torch.zeros(2, 8, dtype=torch.int64), True, "int32"),
    (torch.zeros(3, 8, dtype=torch.int32), True, "batch"),
    (torch.zeros(2, dtype=torch.int32), True, "batch"),
    (torch.zeros(2, 8, dtype=torch.int32), False, "causal"),
])
def test_bad_seg_starts_raise(seg, causal, msg):
    q = torch.zeros(2, 128, 4, 64)
    kv = torch.zeros(2, 128, 2, 64)
    with pytest.raises(ValueError, match=msg):
        tfa.flash_attention(q, kv, kv, causal=causal, seg_starts=seg)


#: the train step's attention call (2 folds x 16 packed rows of 1024,
#: Qwen2.5-0.5B heads), Llama-3-8B heads at S=2048 (where the TPU dispatches
#: its K2 bodies), a 128-token case and one tile (S=64) at both head dims,
#: and packed rows at Qwen2.5-7B's heads (28/4, D=128)
CARD_SHAPES = [(32, 1024, 14, 2, 64), (2, 2048, 32, 8, 128), (5, 128, 14, 2, 64),
               (5, 64, 14, 2, 64), (3, 64, 8, 2, 128), (4, 1024, 28, 4, 128)]


@pytest.mark.cuda
def test_segmented_kernels_match_reference_on_card():
    """bf16 on the card. The segmented forward against its plain version (o
    max|Δ| <= 2e-2, lse <= 1e-3); dq, dk, dv of the segmented backward
    kernels against the f32 plain backward on the same o and lse, and the
    gradients through the Function against autograd of the plain masked
    attention, at max|d - ref| <= 2e-2·max|ref|. Each launches its own
    segmented kernel once, and a second forward call is bit-equal; bad starts
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for b, s, h, kvh, d in CARD_SHAPES:
        q, k, v, do = (torch.from_numpy(a).to("cuda", torch.bfloat16)
                       for a in _inputs(b, s, h, kvh, d, seed=s))
        seg = torch.from_numpy(seg_rows(b, s, seed=s)).cuda()
        before = (tfa.LAUNCHES, tfa.LAUNCHES_SEG)
        o, lse = tfa.flash_attention(q, k, v, seg_starts=seg)
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES, tfa.LAUNCHES_SEG) == (before[0], before[1] + 1)
        o2, lse2 = tfa.flash_attention(q, k, v, seg_starts=seg)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        o_ref, lse_ref = tfa.flash_attention_reference(q, k, v, seg_starts=seg)
        assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2
        assert (lse - lse_ref).abs().max().item() <= 1e-3
        got = tfa.flash_attention_backward(q, k, v, lse, tfa.backward_row_stat(o, do), do,
                                           seg_starts=seg)
        want = tfa.flash_attention_backward_reference(
            q.float(), k.float(), v.float(), o.float(), lse, do.float(), seg_starts=seg)
        for g, w in zip(got, want):
            assert g.abs().max().item() > 0
            assert (g.float() - w).abs().max().item() <= 2e-2 * w.abs().max().item()
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ)
        tfa.flash_attention(*leaves, seg_starts=seg)[0].backward(do)
        torch.cuda.synchronize()
        assert (tfa.LAUNCHES_SEG_BWD_DKV, tfa.LAUNCHES_SEG_BWD_DQ) == (before[0] + 1,
                                                                      before[1] + 1)
        plain = [t.clone().requires_grad_() for t in (q, k, v)]
        tfa.masked_attention(*plain, tfa.segment_mask(seg, s))[0].backward(do)
        for a, p in zip(leaves, plain):
            assert (a.grad.float() - p.grad.float()).abs().max().item() <= (
                2e-2 * p.grad.float().abs().max().item())
    q = torch.zeros(2, 128, 4, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(2, 128, 2, 64, device="cuda", dtype=torch.bfloat16)
    for bad in (torch.zeros(2, 9, dtype=torch.int32, device="cuda"),
                torch.zeros(2, 8, dtype=torch.int64, device="cuda"),
                torch.zeros(2, 8, dtype=torch.int32)):
        with pytest.raises(ValueError):
            tfa.flash_attention(q, kv, kv, seg_starts=bad)
