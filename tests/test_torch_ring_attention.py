"""The port's ring attention (tst_torch.kernels.ring_attention) against the
JAX package's (tst/kernels/ring_attention.py) and against dense attention.

Inputs from a numpy seed, f32. The reference runs on a seq mesh of the fake
CPU devices tests/conftest.py sets up; the port's ring runs in 4 spawned
gloo processes (tests/_torch_mesh_ranks.py), and its per-rank step also in
one process over all blocks (``local_rotate``). Forward within atol 5e-5
(the reference's own bound, tests/test_ring_attention.py:49), gradients of
q, k and v within 1e-4. Both routes of a pair: the plain partials, and K1
(``use_pallas=True``: on CPU tensors K1's plain versions, so these tests
hold the kernel route's blockwise arithmetic and its choice of K1's causal
flag, the card holds the kernels), causal and not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import tst_torch.kernels.flash_attention as tfa
from _torch_mesh_ranks import ring_rank, run_ranks, train_rank
from tst.kernels import ring_attention as jring
from tst.kernels.flash_attention import mha_reference
from tst_torch.kernels import ring_attention as tring
from tst_torch.kernels.flash_attention import masked_attention

ATOL, GRAD_ATOL = 5e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make(b=1, s=256, h=4, kvh=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple((0.4 * rng.normal(size=shape)).astype(np.float32)
                 for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d), (b, s, h, d)))


def _dense(q, k, v, do, causal=True):
    """Dense attention in torch, and its gradients."""
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    s = q.shape[1]
    mask = torch.ones(s, s, dtype=torch.bool)
    mask = mask.tril() if causal else mask
    o = masked_attention(qt, kt, vt, mask)[0]
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do))
    return [o.detach().numpy()] + [g.numpy() for g in grads]


@pytest.mark.parametrize("kv_off", [0, 10_000])
def test_online_partial_matches_the_reference(kv_off):
    """A full block (against the reference and dense attention) and a block
    wholly in the future (lse -inf, output 0)."""
    q, k, v, _ = _make(s=128)
    scale = 1.0 / np.sqrt(32)
    want_o, want_lse = jring._online_partial(*(jnp.asarray(a) for a in (q, k, v)), 0, kv_off,
                                             True, scale, chunk=32)
    got_o, got_lse = tring._online_partial(*(torch.from_numpy(a) for a in (q, k, v)), 0, kv_off,
                                           True, scale, chunk=32)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse), atol=ATOL, rtol=1e-6)
    if kv_off:
        assert (got_lse.numpy() < -1e29).all() and not got_o.any()
    else:
        ref = np.asarray(mha_reference(*(jnp.asarray(a) for a in (q, k, v)), causal=True))
        np.testing.assert_allclose(got_o.numpy(), ref, atol=ATOL)


def test_combine_matches_the_reference():
    rng = np.random.default_rng(1)
    o_a, o_b = (rng.normal(size=(2, 8, 4, 16)).astype(np.float32) for _ in range(2))
    lse_a, lse_b = (rng.normal(size=(2, 8, 4)).astype(np.float32) for _ in range(2))
    lse_b[0, :3] = tring.NEG_INF  # a block this row never saw
    want = jring._combine(*(jnp.asarray(a) for a in (o_a, lse_a, o_b, lse_b)))
    got = tring._combine(*(torch.from_numpy(a) for a in (o_a, lse_a, o_b, lse_b)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=1e-6)


def test_ring_of_4_ranks_matches_the_reference_and_dense():
    """Causal, with GQA groups of 2 and 4: the port's ring over 4 gloo
    ranks, forward and gradients, against the reference's ring on a seq=4
    mesh (jax.grad through its ppermute) and against dense attention."""
    cases = [_make(s=256, h=4, kvh=2), _make(s=256, h=8, kvh=2, seed=1)]
    out = run_ranks(ring_rank, 4, cases)
    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    for c, (q, k, v, do) in enumerate(cases):
        got = [np.concatenate([r[c][i] for r in out], axis=1) for i in range(4)]

        @jax.jit
        def ref(q_, k_, v_, do=jnp.asarray(do)):
            def loss(q_, k_, v_):
                o = jring.ring_attention(q_, k_, v_, mesh, seq_axis="seq", causal=True,
                                         chunk=64)
                return (o * do).sum(), o

            return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q_, k_, v_)

        (_, want_o), want_g = ref(*(jnp.asarray(a) for a in (q, k, v)))
        np.testing.assert_allclose(got[0], np.asarray(want_o), atol=ATOL)
        for g, w in zip(got[1:], want_g):
            np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL)
        dense = _dense(q, k, v, do)
        np.testing.assert_allclose(got[0], dense[0], atol=ATOL)
        for g, w in zip(got[1:], dense[1:]):
            np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_blockwise_ring_in_one_process(n):
    """The ranks' step driven over all n blocks in one process (the
    rotation passed in), forward and backward against dense attention."""
    q, k, v, do = _make(s=128, h=4, kvh=2, d=16, seed=2)
    s = q.shape[1] // n
    blocks = [[torch.from_numpy(np.ascontiguousarray(a[:, i * s: (i + 1) * s]))
               .requires_grad_(True) for i in range(n)] for a in (q, k, v)]
    outs = tring.ring_blocks(*blocks, list(range(n)), n, tring.local_rotate, chunk=16)
    o = torch.cat(outs, 1)
    leaves = [t for group in blocks for t in group]
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do))
    dense = _dense(q, k, v, do)
    np.testing.assert_allclose(o.detach().numpy(), dense[0], atol=ATOL)
    for j in range(3):
        np.testing.assert_allclose(torch.cat(grads[j * n: (j + 1) * n], 1).numpy(),
                                   dense[1 + j], atol=GRAD_ATOL)


def test_one_rank_takes_the_single_partial():
    q, k, v, _ = _make(s=128)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    scale = 1.0 / np.sqrt(32)
    got = tring.ring_attention(qt, kt, vt, None, chunk=32)
    want, _ = tring._online_partial(qt, kt, vt, 0, 0, True, scale, chunk=32)
    assert torch.equal(got, want)
    ref = jring.ring_attention(*(jnp.asarray(a) for a in (q, k, v)),
                               Mesh(np.array(jax.devices()[:1]), ("seq",)), seq_axis="seq",
                               chunk=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def _blocks(arrays, n):
    """Each array cut into n sequence blocks, as leaves."""
    s = arrays[0].shape[1] // n
    return [[torch.from_numpy(np.ascontiguousarray(a[:, i * s: (i + 1) * s]))
             .requires_grad_(True) for i in range(n)] for a in arrays]


def _ring_in_one_process(q, k, v, do, n, causal, use_pallas):
    """The ranks' step over n blocks in one process → [o, dq, dk, dv] whole."""
    blocks = _blocks((q, k, v), n)
    o = torch.cat(tring.ring_blocks(*blocks, list(range(n)), n, tring.local_rotate,
                                    causal=causal, chunk=16, use_pallas=use_pallas), 1)
    grads = torch.autograd.grad(o, [t for group in blocks for t in group], torch.from_numpy(do))
    return [o.detach()] + [torch.cat(grads[j * n: (j + 1) * n], 1) for j in range(3)]


def _jax_ring(q, k, v, do, n, causal):
    """The reference's ring on a seq=n mesh of the fake CPU devices: o and
    jax.grad of sum(o·do) through its ppermute."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("seq",))

    @jax.jit
    def ref(q_, k_, v_, do_):
        def loss(q_, k_, v_):
            o = jring.ring_attention(q_, k_, v_, mesh, seq_axis="seq", causal=causal, chunk=64)
            return (o * do_).sum(), o

        return jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q_, k_, v_)

    (_, o), grads = ref(*(jnp.asarray(a) for a in (q, k, v, do)))
    return [np.asarray(o)] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [2, 4])
def test_kernel_route_in_one_process_matches_the_reference(n, causal):
    """The ring's K1 route over n blocks in one process, forward and
    gradients, against the reference's ring on a seq=n mesh and against
    dense attention; no kernel launched (CPU tensors: K1's plain versions)."""
    q, k, v, do = _make(s=256, h=4, kvh=2, d=64, seed=3 + n)
    before = (tfa.LAUNCHES, tfa.LAUNCHES_FULL, tfa.LAUNCHES_BWD_DQ, tfa.LAUNCHES_FULL_BWD_DQ)
    got = _ring_in_one_process(q, k, v, do, n, causal, use_pallas=True)
    assert (tfa.LAUNCHES, tfa.LAUNCHES_FULL, tfa.LAUNCHES_BWD_DQ,
            tfa.LAUNCHES_FULL_BWD_DQ) == before
    for want in (_jax_ring(q, k, v, do, n, causal), _dense(q, k, v, do, causal)):
        np.testing.assert_allclose(got[0].numpy(), want[0], atol=ATOL)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL)


@pytest.mark.parametrize("idx,src,causal,want", [
    (2, 2, True, True), (2, 0, True, False), (2, 3, True, None), (0, 3, False, False),
    (3, 3, False, False)])
def test_k1_takes_the_diagonal_causal_and_past_blocks_whole(idx, src, causal, want):
    assert tring.k1_causal(idx, src, causal) is want


def test_skipping_future_blocks_is_exact(monkeypatch):
    """The kernel route skips a block wholly in the future. Computing it
    instead (the plain partial: lse -inf, o 0; the plain pair backward:
    every probability 0) gives the same output and gradients, bit for bit."""
    q, k, v, do = _make(s=128, h=4, kvh=2, d=64, seed=9)
    skipped = _ring_in_one_process(q, k, v, do, 4, True, use_pallas=True)
    real_fwd, real_bwd = tring._k1_partial, tring._k1_pair_backward
    computed = []

    def fwd(q_, k_, v_, idx, src, causal):
        part = real_fwd(q_, k_, v_, idx, src, causal)
        if part is None:
            s = q_.shape[1]
            part = tring._online_partial(q_, k_, v_, idx * s, src * s, causal,
                                         1.0 / np.sqrt(q_.shape[-1]), 16)
            computed.append(("fwd", idx, src))
        return part

    def bwd(q_, k_, v_, do_, lse, di, idx, src, causal):
        grads = real_bwd(q_, k_, v_, do_, lse, di, idx, src, causal)
        if grads is None:
            s = q_.shape[1]
            grads = tring._pair_backward(q_, k_, v_, do_, lse.transpose(1, 2),
                                         di.transpose(1, 2), idx * s, src * s, causal,
                                         1.0 / np.sqrt(q_.shape[-1]), 16)
            computed.append(("bwd", idx, src))
        return grads

    monkeypatch.setattr(tring, "_k1_partial", fwd)
    monkeypatch.setattr(tring, "_k1_pair_backward", bwd)
    whole = _ring_in_one_process(q, k, v, do, 4, True, use_pallas=True)
    assert len(computed) == 2 * 6  # the 6 future pairs of 4 blocks, forward and backward
    for a, b in zip(skipped, whole):
        assert torch.equal(a, b)


def test_kernel_route_of_4_gloo_ranks_matches_the_reference():
    """The K1 route over 4 gloo ranks (p2p rotation), causal and not, GQA
    2:1, against the reference's ring and dense attention."""
    cases = [_make(s=256, h=4, kvh=2, d=64, seed=11) + (True,),
             _make(s=256, h=4, kvh=2, d=64, seed=12) + (False,)]
    out = run_ranks(ring_rank, 4, cases, True)
    for c, (q, k, v, do, causal) in enumerate(cases):
        got = [np.concatenate([r[c][i] for r in out], axis=1) for i in range(4)]
        for want in (_jax_ring(q, k, v, do, 4, causal), _dense(q, k, v, do, causal)):
            np.testing.assert_allclose(got[0], want[0], atol=ATOL)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, atol=GRAD_ATOL)


def test_one_rank_kernel_route_is_causal_k1():
    q, k, v, _ = _make(s=128, d=64)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = tring.ring_attention(qt, kt, vt, None, use_pallas=True)
    assert torch.equal(got, tfa.flash_attention(qt, kt, vt)[0])
    with pytest.raises(ValueError, match="default scale"):
        tring.ring_attention(qt, kt, vt, None, sm_scale=0.1, use_pallas=True)


def test_seq2_train_step_through_k1_matches_the_plain_ring():
    """FoldTrainer steps sequence-parallel on 2 gloo ranks (mesh seq=2),
    the ring through K1 (use_pallas) and through the plain partials: the
    same fold losses and held-out probabilities within f32 rounding."""
    cfgs = [{"shape": (1, 1, 2, 1), "ring": True, "use_pallas": up} for up in (True, False)]
    (k1, plain), _ = run_ranks(train_rank, 2, cfgs)
    np.testing.assert_allclose(k1[0], plain[0], rtol=1e-5)
    np.testing.assert_allclose(k1[1], plain[1], atol=1e-6)
