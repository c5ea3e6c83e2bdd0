"""Packed-int4 dequant-matmul parity for the PyTorch port
(tst_torch.kernels.quant_matmul).

On the CPU the plain version, ``int4_matmul_reference``, is held to the JAX
package's Pallas kernel (``int4_matmul_stacked`` in interpret mode, as
tests/test_quant.py runs it) on the same numpy-made, JAX-quantized stacks:
f32 y, rtol and atol 2e-4 (the JAX suite's own kernel-vs-qdot bound: the
kernel sums its K blocks in another order). The TPU kernel takes M in
multiples of 8, so its y is zero-padded to one, as the decode step pads it.
The CUDA kernel runs only on a card: the ``cuda`` tests skip without one.
jax is imported inside the fixtures, so those collect where jax is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_quant_matmul.py
"""

import inspect
import sys
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

import tst_torch.kernels.quant_matmul as tqm
from tst_torch.models import quant as tquant


@pytest.fixture
def jax_qm(monkeypatch):
    import tst.kernels.quant_matmul as qm

    monkeypatch.setattr(qm, "_INTERPRET", True)
    return qm


def _stack(n_layers, k, n, seed):
    """A JAX-quantized int4 stack [L, K, N/2] + scales, as numpy arrays."""
    import jax.numpy as jnp

    from tst.models import quant as jquant

    w = np.random.default_rng(seed).normal(size=(n_layers, k, n)).astype(np.float32) * 0.05
    leaf = jquant.quantize_leaf(jnp.asarray(w), bits=4)
    return np.array(leaf["q"]), np.array(leaf["scale"])


def _y(m, k, seed):
    return np.random.default_rng(seed).normal(size=(m, k)).astype(np.float32)


@pytest.mark.parametrize("m,k,n,layer,blocks", [
    (8, 256, 256, 0, {}),
    (13, 512, 512, 2, {"block_n": 128, "block_k": 128}),  # multi-block K and N
    (5, 384, 256, 1, {"block_k": 128}),
    (21, 256, 128, 2, {}),
])
def test_plain_matches_pallas_interpret(jax_qm, m, k, n, layer, blocks):
    import jax.numpy as jnp

    q, scale = _stack(3, k, n, seed=k + n)
    y = _y(m, k, seed=m)
    y_pad = np.pad(y, ((0, (-m) % 8), (0, 0)))
    want = np.asarray(jax_qm.int4_matmul_stacked(jnp.asarray(y_pad), jnp.asarray(q),
                                                 jnp.asarray(scale), layer, **blocks))[:m]
    tq, ts, ty = map(torch.from_numpy, (q, scale, y))
    before = tqm.LAUNCHES
    got = tqm.int4_matmul_stacked(ty, tq, ts, layer)
    assert tqm.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    assert torch.equal(got, tqm.int4_matmul_reference(ty, tq, ts, layer))


def test_two_d_wrapper_and_qdot(jax_qm):
    """``int4_matmul`` (one layer) against the JAX 2-D wrapper, and the
    plain version against the port's ``qdot`` of the same leaf."""
    import jax.numpy as jnp

    q, scale = _stack(1, 256, 384, seed=1)
    y = _y(16, 256, seed=2)
    want = np.asarray(jax_qm.int4_matmul(jnp.asarray(y), jnp.asarray(q[0]),
                                         jnp.asarray(scale[0])))
    tq, ts, ty = map(torch.from_numpy, (q[0], scale[0], y))
    got = tqm.int4_matmul(ty, tq, ts)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    via_qdot = tquant.qdot(ty, {"q": tq, "scale": ts}, torch.float32, preferred=torch.float32)
    np.testing.assert_allclose(got.numpy(), via_qdot.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("y_shape,q_shape,s_shape,layer,dtype,msg", [
    ((4, 256), (2, 256, 64), (2, 2, 1, 128), 0, torch.bfloat16, None),
    ((4, 200), (2, 200, 64), (2, 1, 1, 128), 0, torch.bfloat16, "multiple of 128"),
    ((4, 256), (2, 256, 64), (2, 2, 1, 96), 0, torch.bfloat16, "do not match"),
    ((4, 256), (2, 256, 64), (2, 2, 1, 128), 2, torch.bfloat16, "outside the stack"),
    ((4, 256), (2, 256, 32), (2, 2, 1, 64), 0, torch.bfloat16, "multiple of 64"),
    ((0, 256), (2, 256, 64), (2, 2, 1, 128), 0, torch.bfloat16, "M >= 1"),
    ((4, 256), (2, 256, 64), (2, 2, 1, 128), 0, torch.float32, "bfloat16"),
])
def test_kernel_argument_checks(y_shape, q_shape, s_shape, layer, dtype, msg):
    y = torch.zeros(y_shape, dtype=dtype)
    q = torch.zeros(q_shape, dtype=torch.int8)
    scale = torch.zeros(s_shape, dtype=torch.float32)
    if msg is None:
        tqm.check_kernel_args(y, q, scale, layer)
    else:
        with pytest.raises(ValueError, match=msg):
            tqm.check_kernel_args(y, q, scale, layer)


def test_unsupported_device_raises():
    y = torch.zeros(4, 256, device="meta")
    q = torch.zeros(1, 256, 64, dtype=torch.int8, device="meta")
    s = torch.zeros(1, 2, 1, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tqm.int4_matmul_stacked(y, q, s, 0)


#: chip_smoke.py's shapes (K, N): Qwen2.5-0.5B's int4 leaves and Llama-3-8B's,
#: then phase 25's: Qwen2.5-7B's, Qwen2.5-1.5B's k/v and down, Llama-3.2-1B's
CARD_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
               (1536, 256), (8960, 1536), (2048, 2048), (2048, 512), (2048, 8192),
               (8192, 2048)]


@pytest.mark.parametrize("k,n", CARD_SHAPES + [(128, 128), (256, 256), (1024, 128)])
@pytest.mark.parametrize("m", [1, 7, 32, 64, 100, 1000])
def test_split_plan_covers_k(m, k, n):
    """The groups of K go to at most MAX_SPLITS blocks of one cluster, none
    empty, covering K exactly and once; more splits only where the column
    blocks of one row tile leave the card short of TARGET_BLOCKS. The plan
    takes no M, so every M of a leaf sums K in one order (speculative
    decode's verify chunk gets the bits of a greedy step's rows)."""
    assert list(inspect.signature(tqm.split_plan.__wrapped__).parameters) == ["k", "n_half"]
    splits, per = tqm.split_plan(k, n // 2)
    groups = k // tqm.GROUP
    assert 1 <= splits <= tqm.MAX_SPLITS and splits <= groups
    ranges = [range(s * per, min((s + 1) * per, groups)) for s in range(splits)]
    assert all(len(r) > 0 for r in ranges)
    assert [g for r in ranges for g in r] == list(range(groups))
    blocks = n // 2 // tqm.NH_MULTIPLE
    if splits > 1:
        assert blocks * (splits - 1) < tqm.TARGET_BLOCKS
    assert tqm.split_plan(k, n // 2) == (splits, per)
    # the kernel's entry gets the plan's splits at any M
    calls = []
    with mock.patch.object(tqm, "_entry", return_value=lambda *a: calls.append(a) or 0):
        y = torch.zeros(m, k, dtype=torch.bfloat16, device="meta")
        q = torch.zeros(1, k, n // 2, dtype=torch.int8, device="meta")
        s = torch.zeros(1, k // tqm.GROUP, 1, n, device="meta")
        with mock.patch.object(tqm._build, "current_stream", return_value=0):
            tqm._launch(y, q, s, 0)
    assert calls[0][8] == splits


def test_split_plan_of_the_decode_step():
    """Qwen2.5-0.5B's leaves, at every M: 7 splits of one group on the narrow
    leaves, 4 on gate/up (38 column blocks), 8 of up to 5 groups on w_down."""
    assert tqm.split_plan(896, 64) == (7, 1)
    assert tqm.split_plan(896, 448) == (7, 1)
    assert tqm.split_plan(896, 2432) == (4, 2)
    assert tqm.split_plan(4864, 448) == (8, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 32, 64, 100])
def test_kernel_matches_reference_on_card(m):
    """bf16 y, layer 1 of a 2-layer stack: max|out - ref| <= 1e-2 max|ref|
    (the same bf16 weights; f32 sums in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for k, n in CARD_SHAPES[:4] if m != 64 else CARD_SHAPES:
        w = torch.randn(2, k, n, device="cuda") * 0.05
        leaf = tquant.quantize_leaf(w, bits=4)
        y = torch.randn(m, k, device="cuda").to(torch.bfloat16)
        before = tqm.LAUNCHES
        got = tqm.int4_matmul_stacked(y, leaf["q"], leaf["scale"], 1)
        torch.cuda.synchronize()
        assert tqm.LAUNCHES == before + 1
        want = tqm.int4_matmul_reference(y, leaf["q"], leaf["scale"], 1)
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), (m, k, n, err)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 7, 32, 64])
def test_kernel_one_launch_bit_equal_on_card(m):
    """Every Qwen2.5-0.5B and Llama-3-8B leaf, the narrow wk/wv (N/2 = 64)
    included, at decode's M and below: one launch a call (one kernel node in
    a CUDA graph of a call), within 1e-2 max|ref| of the plain version, and
    bit-equal on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import graph_kernels

    g = torch.Generator(device="cuda").manual_seed(m)
    for k, n in CARD_SHAPES:
        w = (torch.randn(2, k, n, device="cuda", generator=g) / k ** 0.5).to(torch.bfloat16)
        leaf = tquant.quantize_leaf(w, bits=4)
        q, sc = leaf["q"], leaf["scale"]
        y = torch.randn(m, k, device="cuda", generator=g).to(torch.bfloat16)
        got = tqm.int4_matmul_stacked(y, q, sc, 1)
        again = tqm.int4_matmul_stacked(y, q, sc, 1)
        assert torch.equal(got, again), (m, k, n)
        assert graph_kernels(lambda: tqm.int4_matmul_stacked(y, q, sc, 1)) == 1, (m, k, n)
        want = tqm.int4_matmul_reference(y, q, sc, 1)
        err = (got - want).abs().max().item()
        assert err <= 1e-2 * want.abs().max().item(), (m, k, n, err)
