"""Fused SwiGLU MLP parity for the PyTorch port (tst_torch.kernels.fused_mlp).

On the CPU the wrapper's plain forward and its autograd Function's backward
(the reference's f32 recomputation) are held to the JAX package's
``fused_swiglu_mlp`` (the Pallas kernel in interpret mode and its
custom_vjp, as tests/test_fused_mlp.py runs them) on the same numpy inputs,
at that suite's tolerances: forward atol 2e-5, gradients atol and rtol 1e-3.
The CUDA kernel runs only on a card: the ``cuda`` tests skip without one.
jax is imported inside the fixtures, so those collect where jax is missing:

    python -m pytest --noconftest -m cuda tests/test_torch_fused_mlp.py
"""

import numpy as np
import pytest
import torch

import tst_torch.kernels.fused_mlp as tfm


@pytest.fixture
def jax_fm(monkeypatch):
    import tst.kernels.fused_mlp as fm

    monkeypatch.setattr(fm, "_INTERPRET", True)
    return fm


def _make(m=256, d=64, f=256, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, d)) * 0.3).astype(np.float32)
    wg = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    wu = (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32)
    wd = (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)
    return x, wg, wu, wd


@pytest.mark.parametrize("m,d,f,lead", [
    (256, 64, 256, None), (256, 64, 512, None), (256, 64, 256, (2, 128)),
    (36, 32, 128, None),  # M not a tile multiple: the reference takes the whole M
])
def test_forward_matches_pallas_interpret(jax_fm, m, d, f, lead):
    import jax.numpy as jnp

    arrs = _make(m, d, f, seed=m + f)
    x = arrs[0] if lead is None else arrs[0].reshape(*lead, d)
    want = np.asarray(jax_fm.fused_swiglu_mlp(jnp.asarray(x), *map(jnp.asarray, arrs[1:])))
    tx, twg, twu, twd = map(torch.from_numpy, (x,) + arrs[1:])
    before = tfm.LAUNCHES
    got = tfm.fused_swiglu_mlp(tx, twg, twu, twd)
    assert tfm.LAUNCHES == before  # CPU tensors: the plain version, no launch
    assert got.shape == tx.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(tfm.swiglu_reference(tx, twg, twu, twd).numpy(),
                               np.asarray(jax_fm.swiglu_reference(
                                   jnp.asarray(x), *map(jnp.asarray, arrs[1:]))), atol=2e-5)


def test_gradients_match_custom_vjp(jax_fm):
    """Gradients of sum(out²) in all four inputs through the Function,
    against jax.grad through the reference's custom_vjp and against
    autograd of the plain version."""
    import jax
    import jax.numpy as jnp

    arrs = _make(m=128, d=32, f=128, seed=3)

    def loss(*a):
        return jnp.sum(jax_fm.fused_swiglu_mlp(*a, block_m=128, block_f=128) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, arrs))
    leaves = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (tfm.fused_swiglu_mlp(*leaves) ** 2).sum().backward()
    plain = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (tfm.swiglu_reference(*plain) ** 2).sum().backward()
    for t, p, w, name in zip(leaves, plain, want, ["x", "wg", "wu", "wd"]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(t.grad.numpy(), p.grad.numpy(), atol=1e-3, rtol=1e-3,
                                   err_msg=name)


def test_frozen_weights_get_no_gradient():
    """The frozen base: only x needs a gradient, and it is the same number
    as when every input needs one."""
    arrs = _make(m=64, d=32, f=64, seed=4)
    x = torch.from_numpy(arrs[0]).requires_grad_()
    ws = [torch.from_numpy(a) for a in arrs[1:]]
    (tfm.fused_swiglu_mlp(x, *ws) ** 2).sum().backward()
    every = [torch.from_numpy(a).requires_grad_() for a in arrs]
    (tfm.fused_swiglu_mlp(*every) ** 2).sum().backward()
    assert torch.equal(x.grad, every[0].grad)
    assert all(w.grad is None for w in ws)


@pytest.mark.parametrize("m,d,f,dtype,msg", [
    (32, 128, 64, torch.bfloat16, None),
    (32, 96, 64, torch.bfloat16, "multiple of 128"),
    (32, 128, 96, torch.bfloat16, "of 64"),
    (0, 128, 64, torch.bfloat16, "M >= 1"),
    (32, 128, 64, torch.float32, "bfloat16"),
])
def test_kernel_argument_checks(m, d, f, dtype, msg):
    x = torch.zeros(m, d, dtype=dtype)
    wg, wu, wd = (torch.zeros(d, f, dtype=dtype), torch.zeros(d, f, dtype=dtype),
                  torch.zeros(f, d, dtype=dtype))
    if msg is None:
        tfm.check_kernel_args(x, wg, wu, wd)
    else:
        with pytest.raises(ValueError, match=msg):
            tfm.check_kernel_args(x, wg, wu, wd)
    with pytest.raises(ValueError, match="do not match"):
        tfm.check_kernel_args(torch.zeros(4, 128, dtype=dtype), wg, wu, wd.T)


#: (M, D, F): a Qwen2.5-0.5B train chunk, one that is not a tile multiple,
#: and a Llama-3-8B width (chip_smoke.py times the full train shape)
CARD_SHAPES = [(1024, 896, 4864), (1000, 896, 4864), (256, 4096, 14336)]


@pytest.mark.cuda
def test_kernel_matches_reference_on_card():
    """bf16: forward max|Δ| <= 2e-2 max|ref|; gradients through the Function
    against autograd of the plain version at the same relative bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for m, d, f in CARD_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(m)
        x = torch.randn(m, d, device="cuda", generator=g).to(torch.bfloat16)
        wg, wu = ((torch.randn(d, f, device="cuda", generator=g) / d ** 0.5).to(torch.bfloat16)
                  for _ in range(2))
        wd = (torch.randn(f, d, device="cuda", generator=g) / f ** 0.5).to(torch.bfloat16)
        before = tfm.LAUNCHES
        xk = x.clone().requires_grad_()
        out = tfm.fused_swiglu_mlp(xk, wg, wu, wd)
        torch.cuda.synchronize()
        assert tfm.LAUNCHES == before + 1
        xp = x.clone().requires_grad_()
        ref = tfm.swiglu_reference(xp, wg, wu, wd)
        assert (out.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()
        dout = torch.randn_like(out)
        out.backward(dout)
        ref.backward(dout)
        assert (xk.grad.float() - xp.grad.float()).abs().max() <= \
            2e-2 * xp.grad.float().abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 1000, 4096])
@pytest.mark.parametrize("d,f", [(896, 4864), (4096, 14336)])
def test_kernel_pair_bit_equal_on_card(m, d, f):
    """The gate-up and down kernels at Qwen2.5-0.5B and Llama-3-8B widths,
    M from one row up: forward within 2e-2 max|ref| of the plain version,
    one count a call, and bit-equal on a second call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(m + d)
    x = torch.randn(m, d, device="cuda", generator=g).to(torch.bfloat16)
    wg, wu = ((torch.randn(d, f, device="cuda", generator=g) / d ** 0.5).to(torch.bfloat16)
              for _ in range(2))
    wd = (torch.randn(f, d, device="cuda", generator=g) / f ** 0.5).to(torch.bfloat16)
    before = tfm.LAUNCHES
    out = tfm.fused_mlp_forward(x, wg, wu, wd)
    again = tfm.fused_mlp_forward(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert tfm.LAUNCHES == before + 2
    assert torch.equal(out, again)
    ref = tfm.swiglu_reference(x, wg, wu, wd)
    assert (out.float() - ref.float()).abs().max() <= 2e-2 * ref.float().abs().max()
