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


#: chip_smoke.py's shapes (K, N): Qwen2.5-0.5B's int4 leaves and Llama-3-8B's
CARD_SHAPES = [(896, 896), (896, 128), (896, 4864), (4864, 896),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


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
