"""The port's weights-only quantization against tst.models.quant.

Inputs come from numpy seeds. ``q`` and ``scale`` must be bit-equal to the
JAX package's (the same f32 operations, round-half-even on both sides);
dequantization, ``qdot`` and the quantized decoder agree within f32
summation noise (1e-6 relative to the output, 1e-5 for a whole forward).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.models import decoder as jdec
from tst.models import quant as jquant
from tst_torch import bridge
from tst_torch.models import decoder as tdec
from tst_torch.models import quant as tquant
from tst_torch.models.spec import ModelSpec

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
#: every layer matrix of this geometry takes int4 (input dims multiples of 128)
WIDE = dataclasses.replace(TINY, name="wide", d_model=128, n_heads=4, n_kv_heads=2, d_head=32,
                           d_ff=256, qkv_bias=True)


def _port_spec(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _weight(shape, seed, scale=0.05):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _np_leaf(leaf):
    return {k: np.asarray(v) for k, v in leaf.items()}


@pytest.mark.parametrize("shape,bits", [
    ((256, 96), 8), ((3, 128, 64), 8), ((256, 96), 4), ((3, 384, 64), 4),
    ((3, 64, 64), 4),  # input axis not a multiple of 128: int8 per channel
    ((40,), 8),
])
def test_quantize_leaf_bit_equal(shape, bits):
    w = _weight(shape, seed=sum(shape) + bits)
    w[..., 0] = 0.0  # an all-zero column takes the 1e-12 scale floor
    got = tquant.quantize_leaf(torch.from_numpy(w), bits=bits)
    want = _np_leaf(jquant.quantize_leaf(jnp.asarray(w), bits=bits))
    assert got["q"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), want["q"])
    np.testing.assert_array_equal(got["scale"].numpy(), want["scale"])
    assert tquant.leaf_logical_shape(got) == jquant.leaf_logical_shape(want) == shape
    assert tquant.is_int4_leaf(got) == (want["scale"].ndim == want["q"].ndim + 1)


def test_quantize_leaf_rejects_bits():
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tquant.quantize_leaf(torch.zeros(4, 4), bits=3)


@pytest.mark.parametrize("shape,bits", [((256, 96), 8), ((384, 64), 4), ((2, 256, 128), 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_and_qdot_match_reference(shape, bits, dtype):
    jleaf = jquant.quantize_leaf(jnp.asarray(_weight(shape, seed=7)), bits=bits)
    leaf = bridge.to_torch(jax.tree.map(np.asarray, jleaf))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jquant.dequantize_leaf(jleaf, jdt).astype(jnp.float32))
    got = tquant.dequantize_leaf(leaf, tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)  # elementwise: exact
    if len(shape) == 2:
        y = np.random.default_rng(8).normal(size=(5, shape[0])).astype(np.float32)
        jy, ty = jnp.asarray(y, jdt), torch.from_numpy(y).to(tdt)
        for pref_j, pref_t in ((None, None), (jnp.float32, torch.float32)):
            w = np.asarray(jquant.qdot(jy, jleaf, jdt, preferred=pref_j).astype(jnp.float32))
            g = tquant.qdot(ty, leaf, tdt, preferred=pref_t)
            assert g.dtype == (pref_t or tdt)
            tol = 1e-6 if dtype == "float32" or pref_t else 1e-2
            np.testing.assert_allclose(g.float().numpy(), w, atol=tol * np.abs(w).max())


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_and_bridge_round_trip(bits):
    """quantize_params of the same tree: the same keys, bit-equal leaves;
    the bridge carries quantized trees both ways bit for bit."""
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(3), WIDE))
    want = jax.tree.map(np.asarray, jquant.quantize_params(
        jax.tree.map(jnp.asarray, params), bits=bits))
    got = tquant.quantize_params(bridge.to_torch(params), bits=bits)
    back = bridge.to_numpy(got)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    across = bridge.to_torch(want)
    assert across["layers"]["wq"]["q"].dtype == torch.int8
    for a, b in zip(jax.tree.leaves(bridge.to_numpy(across)), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)
    assert tquant.quantized_bytes(got) == jquant.quantized_bytes(want)
    assert tquant.is_int4_leaf(got["layers"]["w_down"]) == (bits == 4)
    assert not tquant.is_int4_leaf(got["embed"])  # embed and head stay int8
    for key in ("wq", "embed", "attn_norm"):
        assert tquant.leaf_bits(key, bits) == jquant.leaf_bits(key, bits)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_decoder_matches_reference(bits):
    """apply_model, embed_lookup and lm_head_weight on a quantized tree (the
    JAX init's own quantized weights, bridged): f32 logits within 1e-5."""
    for spec in (WIDE, dataclasses.replace(WIDE, tie_embeddings=False)):
        params = jdec.init_params(jax.random.key(4), spec, quantize=True, bits=bits)
        tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
        tokens = np.random.default_rng(5).integers(0, spec.vocab_size, (2, 64)).astype(np.int32)
        want = np.asarray(jdec.apply_model(params, jnp.asarray(tokens), spec))
        got = tdec.apply_model(tparams, torch.from_numpy(tokens), _port_spec(spec))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
        np.testing.assert_array_equal(
            tdec.embed_lookup(tparams, torch.from_numpy(tokens), _port_spec(spec)).numpy(),
            np.asarray(jdec.embed_lookup(params, jnp.asarray(tokens), spec)))
        np.testing.assert_array_equal(
            tdec.lm_head_weight(tparams, _port_spec(spec)).numpy(),
            np.asarray(jdec.lm_head_weight(params, spec)))
