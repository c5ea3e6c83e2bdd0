"""The decode step's attention over its cache (tst_torch.kernels.decode_attention):
the shapes the kernel takes, its plain version against the reference's
arithmetic and across rank-chunk boundaries on the CPU, and (on a card) the
CUDA kernel against its plain version with F1's invariances.

F1: a query's output bits depend only on the query and on the keys and values
of its visible slots in rank order, never on T (the queries a call), S (the
cache's length), where masked slots sit, or which heads share a block. The
card test is marked ``cuda`` and skips without one; it imports no jax:

    python -m pytest --noconftest -m cuda tests/test_torch_decode_attention.py
"""

import numpy as np
import pytest
import torch

from tst_torch.kernels import decode_attention as tda


def _case(rng, b, t, h, kvh, d, s, dtype=torch.float32):
    q, k, v = (torch.from_numpy(rng.normal(0.0, 0.5, shape).astype(np.float32)).to(dtype)
               for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    return q, k, v


def _spread(rng, keys, values, s, n_first, t):
    """keys/values [b, vis, kvh, d] at random sorted slots of a cache of s
    (the other slots noise) and the mask of query j: the first n_first + j of
    those slots → (k, v, mask)."""
    b, vis = keys.shape[:2]
    k, v = (torch.from_numpy(rng.normal(0.0, 0.5, (b, s) + tuple(keys.shape[2:]))
                             .astype(np.float32)).to(keys.device, keys.dtype) for _ in range(2))
    mask = torch.zeros((b, t, s), dtype=torch.bool, device=keys.device)
    for row in range(b):
        pos = torch.from_numpy(np.sort(rng.choice(s, vis, replace=False))).to(keys.device)
        k[row, pos], v[row, pos] = keys[row], values[row]
        for j in range(t):
            mask[row, j, pos[:n_first + j]] = True
    return k, v, mask


def _kernel_args(b=2, t=3, h=14, kvh=2, d=64, s=640):
    q = torch.zeros((b, t, h, d), dtype=torch.bfloat16)
    k, v = (torch.zeros((b, s, kvh, d), dtype=torch.bfloat16) for _ in range(2))
    return q, k, v, torch.zeros((b, t, s), dtype=torch.bool)


@pytest.mark.parametrize("d,s", [(64, 1), (128, 640), (64, tda.MAX_SLOTS), (128, tda.MAX_SLOTS)])
def test_kernel_takes_both_head_dims_up_to_its_slot_limit(d, s):
    """Every shape the kernel took before its redesign is still taken: head
    dims 64 and 128, one slot to MAX_SLOTS (27648)."""
    assert tda.MAX_SLOTS == 27648 and tda.HEAD_DIMS == (64, 128)
    tda.check_kernel_args(*_kernel_args(b=1, t=1, d=d, s=s))


@pytest.mark.parametrize("bad", ["head dim 96", "H not a multiple of KVH", "too many slots",
                                 "a mask of another length", "k in f32", "q not contiguous"])
def test_kernel_args_refuse_what_the_kernel_does_not_take(bad):
    """What the C entry refuses is refused before the launch, with a
    ValueError: never a silent fallback to the plain version."""
    if bad == "head dim 96":
        args = _kernel_args(d=96)
    elif bad == "H not a multiple of KVH":
        args = _kernel_args(h=15)
    elif bad == "too many slots":
        args = _kernel_args(b=1, t=1, h=2, kvh=1, s=tda.MAX_SLOTS + 1)
    elif bad == "a mask of another length":
        q, k, v, mask = _kernel_args()
        args = q, k, v, mask[..., 1:]
    elif bad == "k in f32":
        q, k, v, mask = _kernel_args()
        args = q, k.float(), v, mask
    else:
        q, k, v, mask = _kernel_args()
        args = q.transpose(1, 2).contiguous().transpose(1, 2), k, v, mask
    with pytest.raises(ValueError):
        tda.check_kernel_args(*args)


@pytest.mark.parametrize("n", [63, 64, 65])
def test_plain_version_matches_the_reference_arithmetic(n):
    """The plain version against the reference decode step's attention
    (tst/models/decode.py:194-201, its jnp lines on the same numpy inputs,
    f32), for visible counts on both sides of a rank chunk: atol 1e-5 (f32
    sums in another order)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    b, t, h, kvh, d, s = 2, 3, 4, 2, 16, n + 12
    q, keys, values = _case(rng, b, t, h, kvh, d, n + t - 1)
    k, v, mask = _spread(rng, keys, values, s, n, t)
    got = tda.cache_attention_reference(q, k, v, mask)

    qg = jnp.asarray(q.numpy()).reshape(b, t, kvh, h // kvh, d)
    scores = jnp.einsum("btkgd,bskd->bkgts", qg, jnp.asarray(k.numpy()),
                        preferred_element_type=jnp.float32) / np.sqrt(d)
    scores = jnp.where(jnp.asarray(mask.numpy())[:, None, None, :, :], scores, -1e30)
    probs = jax.nn.softmax(scores, axis=-1).astype(jnp.float32)
    want = jnp.einsum("bkgts,bskd->btkgd", probs, jnp.asarray(v.numpy()),
                      preferred_element_type=jnp.float32).reshape(b, t, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [63, 1022, 2047])
def test_plain_version_keeps_f1_across_chunk_boundaries(n, dtype):
    """The plain version (the CPU path) gives a query the same bits alone and
    in a T=3 call, and in a cache with masked slots between its keys and one
    three superchunks longer, at visible counts n .. n + 2 that span a rank
    chunk, a superchunk (1024 at D=64) and two."""
    rng = np.random.default_rng(n)
    b, t, h, kvh, d = 1, 3, 4, 2, 64
    q, keys, values = _case(rng, b, t, h, kvh, d, n + t - 1, dtype)
    outs = []
    for s in (n + t + 6, n + t - 1 + 3 * 1024):
        k, v, mask = _spread(rng, keys, values, s, n, t)
        got = tda.cache_attention_reference(q, k, v, mask)
        for j in range(t):
            alone = tda.cache_attention_reference(q[:, j: j + 1], k, v, mask[:, j: j + 1])
            assert torch.equal(alone, got[:, j: j + 1])
        outs.append(got)
    assert torch.equal(outs[0], outs[1])


def _card_cases():
    """(H, KVH, D, n, T): Qwen2.5-0.5B's and Llama-3-8B's head layouts with n
    just below a rank chunk and a superchunk, and a group of 18 query heads
    (more than the 16 rows one block holds)."""
    cases = []
    for h, kvh, d in ((14, 2, 64), (32, 8, 128), (36, 2, 64)):
        sup = tda.rank_plan(d)[1]
        cases += [(h, kvh, d, 63, 3), (h, kvh, d, sup - 2, 3), (h, kvh, d, 2 * sup - 1, 3)]
    return cases


@pytest.mark.cuda
def test_kernel_matches_plain_and_keeps_f1_on_card():
    """bf16 on the card: the kernel within 2e-2·max|ref| of its plain
    version (one bf16 rounding of p and of the output); each query of a T=3
    call bit-equal to the same query alone; the same visible keys in a cache
    with masked gaps (the one-kernel path where it fits) and in one three
    superchunks and 130 slots longer (the two-kernel path) bit-equal; every
    call launched once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    b = 2
    for h, kvh, d, n, t in _card_cases():
        sup = tda.rank_plan(d)[1]
        q, keys, values = (x.to("cuda") for x in
                           _case(rng, b, t, h, kvh, d, n + t - 1, torch.bfloat16))
        vis = n + t - 1
        outs = []
        for s in (vis if vis == sup else vis + 7, vis + 3 * sup + 130):
            k, v, mask = _spread(rng, keys, values, s, n, t)
            before = tda.LAUNCHES
            got = tda.cache_attention(q, k, v, mask)
            torch.cuda.synchronize()
            assert tda.LAUNCHES == before + 1
            want = tda.cache_attention_reference(q, k, v, mask).float()
            assert (got.float() - want).abs().max().item() <= 2e-2 * want.abs().max().item()
            assert torch.equal(tda.cache_attention(q, k, v, mask), got)
            for j in range(t):
                alone = tda.cache_attention(q[:, j: j + 1].contiguous(), k, v,
                                            mask[:, j: j + 1].contiguous())
                assert torch.equal(alone, got[:, j: j + 1])
            outs.append(got)
        assert torch.equal(outs[0], outs[1]), (h, kvh, d, n)
