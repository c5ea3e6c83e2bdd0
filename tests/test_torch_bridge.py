"""JAX parameter trees cross into the port and back with exact shapes, dtypes
and values (bf16 leaves bit for bit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.models import decoder as jdec
from tst_torch import bridge

#: narrow Qwen-style spec: QKV biases, untied head, GQA 2:1
NARROW = jdec.ModelSpec("narrow", vocab_size=300, d_model=32, n_layers=2, n_heads=4,
                        n_kv_heads=2, d_head=8, d_ff=48, qkv_bias=True,
                        tie_embeddings=False)
TORCH_DTYPE = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _flat(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("spec", [jdec.spec_by_name("tiny"), NARROW], ids=["tiny", "narrow"])
def test_roundtrip_exact(spec, dtype):
    spec = dataclasses.replace(spec, dtype=dtype)
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(3), spec))
    if spec.qkv_bias:  # non-zero biases, so a dropped or misplaced leaf shows
        rng = np.random.default_rng(0)
        for key in ("bq", "bk", "bv"):
            b = params["layers"][key]
            params["layers"][key] = rng.normal(size=b.shape).astype(b.dtype)
    tree = bridge.to_torch(params)
    back = bridge.to_numpy(tree)
    ref, got, ret = dict(_flat(params)), dict(_flat(tree)), dict(_flat(back))
    assert list(ref) == list(got) == list(ret)
    assert ("lm_head" in got) == (not spec.tie_embeddings)
    assert ("layers.bq" in got) == spec.qkv_bias
    for path, a in ref.items():
        t = got[path]
        assert tuple(t.shape) == a.shape, path
        assert t.dtype == TORCH_DTYPE[a.dtype.name], path
        np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32), err_msg=path)
        assert ret[path].dtype == a.dtype, path
        np.testing.assert_array_equal(ret[path].view(np.uint8), a.view(np.uint8), err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_leaves_cross_bit_exact(bits):
    """{"q", "scale"} leaves (int8 per channel, int4 packed with grouped
    scales) cross as int8 and f32 tensors and come back bit for bit."""
    params = jax.tree.map(np.asarray, jdec.init_params(
        jax.random.key(0), jdec.spec_by_name("tiny"), quantize=True, bits=bits))
    tree = bridge.to_torch(params)
    assert tree["layers"]["wq"]["q"].dtype == torch.int8
    assert tree["layers"]["w_down"]["scale"].dtype == torch.float32
    assert tree["layers"]["w_down"]["scale"].ndim == (4 if bits == 4 else 3)
    for (path, a), (path2, b) in zip(_flat(params), _flat(bridge.to_numpy(tree))):
        assert path == path2 and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=path)


def test_quantized_leaves_raise():
    """Quantized leaves streamed from an HF checkpoint (``quantizing_put``,
    held bit-equal to the reference in tests/test_torch_hf_load.py): int4 on
    a layer matrix, norms kept; a width other than 4 or 8 raises, as the
    reference's quantize_leaf does."""
    from tst_torch.models import quant as tquant

    put = tquant.quantizing_put(torch.float32, bits=4)
    assert tquant.is_int4_leaf(put("layers.wq", torch.ones(1, 128, 64)))
    assert put("layers.attn_norm", torch.ones(1, 64)).dtype == torch.float32
    with pytest.raises(ValueError, match="bits must be 4 or 8"):
        tquant.quantize_leaf(torch.ones(128, 64), bits=3)
