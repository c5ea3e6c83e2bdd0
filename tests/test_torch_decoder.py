"""The port's decoder forward against tst.models.decoder on the same weights.

Weights come from the JAX ``init_params`` and cross through tst_torch.bridge;
inputs are made with numpy. Everything runs in f32 on the CPU. Tolerances:
1e-6 for the elementwise functions, atol/rtol 1e-4 for whole models — the
difference between XLA's and torch's CPU summation order over a few layers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.models import decoder as jdec
from tst_torch import bridge
from tst_torch.models import decoder as tdec
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec

#: narrow Qwen2.5-shaped spec: QKV biases, tied head, GQA 7:1, theta 1e6
QWEN = jdec.ModelSpec("narrow-qwen", vocab_size=384, d_model=56, n_layers=2, n_heads=7,
                      n_kv_heads=1, d_head=8, d_ff=96, rope_theta=1000000.0,
                      qkv_bias=True, tie_embeddings=True, dtype=jnp.float32)
#: narrow Llama-3.1-shaped spec: untied head, llama3 RoPE scaling, GQA 4:1
LLAMA = jdec.ModelSpec("narrow-llama3.1", vocab_size=400, d_model=64, n_layers=2,
                       n_heads=8, n_kv_heads=2, d_head=8, d_ff=128, rope_theta=500000.0,
                       rms_eps=1e-5, rope_scaling=("llama3", 8.0, 1.0, 4.0, 8192),
                       dtype=jnp.float32)
SPECS = {"tiny": dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32),
         "qwen": QWEN, "llama": LLAMA}


def _port_spec(spec: jdec.ModelSpec) -> ModelSpec:
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _params(spec, seed=0):
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(seed), spec))
    rng = np.random.default_rng(seed)
    for key in ("bq", "bk", "bv", "attn_norm", "mlp_norm"):
        if key in params["layers"]:  # non-trivial biases and norm weights
            shape = params["layers"][key].shape
            base = 1.0 if key.endswith("norm") else 0.0
            params["layers"][key] = (base + 0.2 * rng.normal(size=shape)).astype(np.float32)
    return params


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 8, 64)).astype(np.float32)
    w = rng.normal(size=64).astype(np.float32)
    got = tdec.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    want = jdec.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("scaling", [None, ("llama3", 8.0, 1.0, 4.0, 8192),
                                     ("llama3", 32.0, 1.0, 4.0, 8192)])
def test_rope_tables_bit_equal(scaling):
    """Both sides compute in float64 numpy and cast once to f32."""
    got = tdec.rope_tables(300, 64, 500000.0, scaling)
    want = jdec.rope_tables(300, 64, 500000.0, scaling)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="unknown rope scaling"):
        tdec.rope_tables(8, 16, 1e4, ("yarn", 1, 1, 1, 1))


def test_apply_rope():
    x = np.random.default_rng(1).normal(size=(2, 16, 4, 32)).astype(np.float32)
    cos, sin = jdec.rope_tables(16, 32, 10000.0)
    want = jdec.apply_rope(jnp.asarray(x), cos, sin)
    got = tdec.apply_rope(torch.from_numpy(x), *tdec.rope_tables(16, 32, 10000.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", list(SPECS))
def test_apply_model_matches_reference(name):
    spec = SPECS[name]
    params = _params(spec)
    tokens = np.random.default_rng(2).integers(0, spec.vocab_size, (2, 64)).astype(np.int32)
    want_logits = np.asarray(jdec.apply_model(params, jnp.asarray(tokens), spec))
    want_hidden = np.asarray(jdec.apply_model(params, jnp.asarray(tokens), spec,
                                              return_hidden=True))
    tp, tt, ts = bridge.to_torch(params), torch.from_numpy(tokens), _port_spec(spec)
    for use_pallas in (False, True):  # True: the kernel wrapper's CPU (plain) path
        logits = tdec.apply_model(tp, tt, ts, use_pallas=use_pallas)
        hidden = tdec.apply_model(tp, tt, ts, use_pallas=use_pallas, return_hidden=True)
        assert logits.dtype == torch.float32 and logits.shape == (2, 64, spec.vocab_size)
        np.testing.assert_allclose(logits.numpy(), want_logits, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(hidden.numpy(), want_hidden, atol=1e-4, rtol=1e-4)
    module = tdec.Decoder(tp, ts)
    assert torch.equal(module(tt), tdec.apply_model(tp, tt, ts))
    assert sorted(module.tree()["layers"]) == sorted(tp["layers"])


def test_init_params_shapes_and_seed():
    spec = _port_spec(QWEN)
    a = tdec.init_params(torch.Generator().manual_seed(5), spec)
    b = tdec.init_params(torch.Generator().manual_seed(5), spec)
    ref = jax.tree.map(lambda x: x.shape, jdec.init_params(jax.random.key(0), QWEN))
    assert jax.tree.map(lambda x: tuple(x.shape), a) == ref
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    assert a["layers"]["wq"].std().item() == pytest.approx(1 / np.sqrt(56), rel=0.05)


@pytest.mark.parametrize("kw,item", [({"ring_mesh": "one rank"}, "item 16")])
def test_unported_arguments_raise(kw, item):
    """``ring_mesh`` raised until item 16 was ported; a ring of one rank is
    now one partial (tst_torch.kernels.ring_attention), the dense path's
    numbers, and packed rows with a ring of several ranks raise, as in the
    reference."""
    from tst_torch.runtime import mesh as tmesh

    spec = _port_spec(SPECS["tiny"])
    params = tdec.init_params(torch.Generator().manual_seed(0), spec)
    tokens = torch.randint(0, 250, (2, 16), generator=torch.Generator().manual_seed(1))
    one = tmesh.make_mesh()
    got = tdec.apply_model(params, tokens, spec, ring_mesh=one)
    torch.testing.assert_close(got, tdec.apply_model(params, tokens, spec), atol=1e-5,
                               rtol=1e-5)
    two = tmesh.Mesh(np.arange(2).reshape(1, 1, 2, 1), 0, {})
    with pytest.raises(ValueError, match="mutually exclusive"):
        tdec.apply_model(params, tokens, spec, ring_mesh=two,
                         seg_starts=torch.zeros(2, 8, dtype=torch.int32))


def test_lora_rng_drops_only_with_dropout():
    """``lora_rng``: ignored at dropout 0 (as the reference); with dropout it
    moves the logits, the same way every time."""
    spec = _port_spec(SPECS["tiny"])
    g = torch.Generator().manual_seed(0)
    params = tdec.init_params(g, spec)
    lspec = tlora.LoraSpec(rank=4, dtype=torch.float32, dropout=0.3)
    lora = tlora.init_lora(g, spec, lspec)
    for ab in lora.values():
        ab["b"] = 0.3 * torch.randn(ab["b"].shape, generator=g)
    tokens = torch.randint(0, 256, (2, 16), generator=g)
    key = tlora.DropoutKey((0,), 1)
    off = dataclasses.replace(lspec, dropout=0.0)
    plain = tdec.apply_model(params, tokens, spec, lora=lora, lora_spec=off)
    assert torch.equal(tdec.apply_model(params, tokens, spec, lora=lora, lora_spec=off,
                                        lora_rng=key), plain)
    dropped = tdec.apply_model(params, tokens, spec, lora=lora, lora_spec=lspec, lora_rng=key)
    assert not torch.allclose(dropped, plain)
    assert torch.equal(dropped, tdec.apply_model(params, tokens, spec, lora=lora,
                                                 lora_spec=lspec, lora_rng=key))


@pytest.mark.parametrize("name", ["qwen", "llama"])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_return_kv_matches_reference(name, use_pallas):
    """``return_kv=True``: final hidden states and every layer's post-RoPE
    K and V [L, B, S, KVH, dh], atol/rtol 1e-4."""
    spec = SPECS[name]
    params = _params(spec)
    tparams = bridge.to_torch(params)
    tokens = np.random.default_rng(1).integers(0, spec.vocab_size, (2, 64)).astype(np.int32)
    want = jdec.apply_model(params, jnp.asarray(tokens), spec, return_kv=True)
    got = tdec.apply_model(tparams, torch.from_numpy(tokens), _port_spec(spec),
                           use_pallas=use_pallas, return_kv=True)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("targets,fused", [(("q_proj", "v_proj"), True),
                                           (("q_proj", "up_proj"), False)])
def test_fused_mlp_takes_the_reference_condition(monkeypatch, targets, fused):
    """``fused_mlp`` with ``use_pallas`` routes every layer's MLP through
    the fused SwiGLU wrapper unless an adapter targets the MLP; either way
    the logits equal the unfused forward's within 1e-5."""
    from tst_torch.models import lora as tlora

    spec = SPECS["tiny"]
    tparams = bridge.to_torch(_params(spec))
    lspec = tlora.LoraSpec(rank=2, alpha=4.0, targets=targets, dtype=torch.float32)
    lora = tlora.init_lora(torch.Generator().manual_seed(0), _port_spec(spec), lspec)
    for ab in lora.values():
        ab["b"] = 0.1 * torch.randn(ab["b"].shape, generator=torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, spec.vocab_size, (2, 128)).astype(np.int32))
    calls = []
    real = tdec.fused_swiglu_mlp
    monkeypatch.setattr(tdec, "fused_swiglu_mlp", lambda *a: calls.append(1) or real(*a))
    kw = dict(lora=lora, lora_spec=lspec, use_pallas=True)
    got = tdec.apply_model(tparams, tokens, _port_spec(spec), fused_mlp=True, **kw)
    assert len(calls) == (spec.n_layers if fused else 0)
    want = tdec.apply_model(tparams, tokens, _port_spec(spec), **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
