"""LoRA adapters of the port against tst.models.lora, and the decoder's
fold-stacked ``lora=`` path against tst's ``apply_model`` run per fold.

Adapters are made with numpy (B drawn nonzero, so the delta is not 0) or by
the JAX ``init_lora`` and carried across by tst_torch.bridge; f32 on the
CPU. Tolerances: 1e-6 (absolute and relative) for one delta or merge, f32
sums in another order; 1e-5 for a two-layer model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst_torch import bridge
from tst_torch.models import decoder as tdec
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec

#: narrow Qwen2.5-shaped spec: QKV biases, tied head, GQA 7:1
QWEN = jdec.ModelSpec("narrow-qwen", vocab_size=384, d_model=56, n_layers=2, n_heads=7,
                      n_kv_heads=1, d_head=8, d_ff=96, rope_theta=1000000.0,
                      qkv_bias=True, tie_embeddings=True, dtype=jnp.float32)
ALL_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")


def _port_spec(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _jspec(targets=("q_proj", "k_proj", "v_proj", "o_proj"), rank=4):
    return jlora.LoraSpec(rank=rank, alpha=8.0, targets=targets, dtype=jnp.float32)


def _tspec(jspec):
    return tlora.LoraSpec(rank=jspec.rank, alpha=jspec.alpha, targets=jspec.targets,
                          dtype=torch.float32)


def _fold_adapters(spec, lspec, k, seed=0):
    """k JAX adapters stacked on a fold axis, B drawn nonzero: numpy tree."""
    rng = np.random.default_rng(seed)
    loras = [jax.tree.map(np.asarray, jlora.init_lora(key, spec, lspec))
             for key in jax.random.split(jax.random.key(seed), k)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *loras)
    for ab in stacked.values():
        ab["b"] = (0.05 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    return stacked


def test_lora_spec_matches_reference():
    j, t = jlora.LoraSpec(), tlora.LoraSpec()
    assert (t.rank, t.alpha, t.targets, t.dropout) == (j.rank, j.alpha, j.targets, j.dropout)
    assert t.dtype == torch.bfloat16
    assert tlora.lora_scale(t) == jlora.lora_scale(j) == 2.0
    assert tlora.PROJ_TO_TARGET == jlora.PROJ_TO_TARGET
    with pytest.raises(ValueError, match="unknown LoRA targets"):
        tlora.LoraSpec(targets=("qkv",))


def test_init_lora_shapes_and_seed():
    spec, lspec = _port_spec(QWEN), _tspec(_jspec(ALL_TARGETS))
    a = tlora.init_lora(torch.Generator().manual_seed(3), spec, lspec)
    b = tlora.init_lora(torch.Generator().manual_seed(3), spec, lspec)
    want = jax.tree.map(lambda x: x.shape, jlora.init_lora(jax.random.key(0), QWEN,
                                                           _jspec(ALL_TARGETS)))
    assert jax.tree.map(lambda x: tuple(x.shape), a) == want
    for proj, ab in a.items():
        assert torch.equal(ab["a"], b[proj]["a"]) and not ab["b"].any()
    wq = a["q"]["a"]
    assert wq.std().item() == pytest.approx(1 / np.sqrt(QWEN.d_model), rel=0.1)
    assert tlora.lora_param_count(a) == jlora.lora_param_count(
        jlora.init_lora(jax.random.key(0), QWEN, _jspec(ALL_TARGETS)))


def test_apply_lora_delta_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 16, 56)).astype(np.float32)
    ab = {"a": (rng.normal(size=(4, 56)) / np.sqrt(56)).astype(np.float32),
          "b": (0.3 * rng.normal(size=(24, 4))).astype(np.float32)}
    lspec = _jspec()
    want = jlora.apply_lora_delta(jax.tree.map(jnp.asarray, ab), jnp.asarray(x), lspec)
    got = tlora.apply_lora_delta(bridge.to_torch(ab), torch.from_numpy(x), _tspec(lspec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_fold_stacked_delta_is_each_folds_delta():
    """a [k, r, in], b [k, out, r] on fold-major rows [k·B, S, in]: row block
    f gets fold f's delta, exactly."""
    rng = np.random.default_rng(2)
    k, b = 3, 2
    x = torch.from_numpy(rng.normal(size=(k * b, 8, 56)).astype(np.float32))
    ab = {"a": torch.from_numpy(rng.normal(size=(k, 4, 56)).astype(np.float32)),
          "b": torch.from_numpy(rng.normal(size=(k, 24, 4)).astype(np.float32))}
    lspec = _tspec(_jspec())
    got = tlora.apply_lora_delta(ab, x, lspec)
    for f in range(k):
        one = tlora.apply_lora_delta({n: t[f] for n, t in ab.items()}, x[f * b:(f + 1) * b],
                                     lspec)
        np.testing.assert_allclose(got[f * b:(f + 1) * b].numpy(), one.numpy(), atol=1e-6)


def test_merge_lora_matches_reference():
    lspec = _jspec(ALL_TARGETS)
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(0), QWEN))
    lora = jax.tree.map(lambda x: x[0], _fold_adapters(QWEN, lspec, 1))
    want = jlora.merge_lora(params, lora, lspec)
    got = tlora.merge_lora(bridge.to_torch(params), bridge.to_torch(lora), _tspec(lspec))
    for key, w in want["layers"].items():
        np.testing.assert_allclose(got["layers"][key].numpy(), np.asarray(w), atol=1e-6)
    assert got["embed"] is not None and sorted(got) == sorted(want)


@pytest.mark.parametrize("targets", [("q_proj", "k_proj", "v_proj", "o_proj"), ALL_TARGETS])
def test_fold_stacked_apply_model_matches_reference_per_fold(targets):
    """Tokens [k·B, S], fold-major, through the fold-stacked adapters against
    tst's apply_model run per fold with that fold's adapter: logits and
    hidden states at atol 1e-5."""
    k, b, s = 2, 2, 64
    lspec = _jspec(targets)
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(1), QWEN))
    lora = _fold_adapters(QWEN, lspec, k, seed=1)
    tokens = np.random.default_rng(3).integers(0, QWEN.vocab_size, (k * b, s)).astype(np.int32)
    want = [np.asarray(jdec.apply_model(params, jnp.asarray(tokens[f * b:(f + 1) * b]), QWEN,
                                        lora=jax.tree.map(lambda x: x[f], lora),
                                        lora_spec=lspec, return_hidden=hidden))
            for hidden in (False, True) for f in range(k)]
    tp, tl = bridge.to_torch(params), bridge.to_torch(lora)
    for use_pallas in (False, True):
        for hidden in (False, True):
            got = tdec.apply_model(tp, torch.from_numpy(tokens), _port_spec(QWEN), lora=tl,
                                   lora_spec=_tspec(lspec), use_pallas=use_pallas,
                                   return_hidden=hidden).numpy()
            np.testing.assert_allclose(got, np.concatenate(want[hidden * k:(hidden + 1) * k]),
                                       atol=1e-5)


def test_single_adapter_and_row_check():
    """An adapter without the fold axis works as in tst; fold-stacked
    adapters need the rows to split into k blocks."""
    lspec = _jspec()
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(2), QWEN))
    lora = jax.tree.map(lambda x: x[0], _fold_adapters(QWEN, lspec, 1, seed=2))
    tokens = np.random.default_rng(4).integers(0, 384, (3, 32)).astype(np.int32)
    want = jdec.apply_model(params, jnp.asarray(tokens), QWEN, lora=lora, lora_spec=lspec)
    got = tdec.apply_model(bridge.to_torch(params), torch.from_numpy(tokens), _port_spec(QWEN),
                           lora=bridge.to_torch(lora), lora_spec=_tspec(lspec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    stacked = bridge.to_torch(_fold_adapters(QWEN, lspec, 2))
    with pytest.raises(ValueError, match="fold blocks"):
        tdec.apply_model(bridge.to_torch(params), torch.from_numpy(tokens), _port_spec(QWEN),
                         lora=stacked, lora_spec=_tspec(lspec))


def test_bridge_carries_fold_stacked_adapters_both_ways():
    """The FoldTrainer.init_state adapters of the JAX package (bf16,
    [k, L, ...] leaves) cross to torch and back bit for bit."""
    from tst.train.sft import FoldTrainer

    lspec = jlora.LoraSpec(rank=4, alpha=8.0)
    lora, _ = FoldTrainer(QWEN, lspec, 3).init_state(jax.random.key(5))
    lora = jax.tree.map(np.asarray, lora)
    t = bridge.to_torch(lora)
    assert t["q"]["a"].dtype == torch.bfloat16 and t["q"]["a"].shape == (3, 2, 4, 56)
    back = bridge.to_numpy(t)
    for proj, ab in lora.items():
        for name, x in ab.items():
            np.testing.assert_array_equal(back[proj][name].view(np.int16), x.view(np.int16))


def test_dropout_at_training_only():
    """A dropout key drops the adapter's input in training; without one
    (inference, serving) the delta is the no-dropout delta."""
    lspec = tlora.LoraSpec(rank=4, dropout=0.5, dtype=torch.float32)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 56, generator=g)
    ab = {"a": torch.randn(4, 56, generator=g), "b": torch.randn(24, 4, generator=g)}
    plain = tlora.apply_lora_delta(ab, x, dataclasses.replace(lspec, dropout=0.0))
    assert torch.equal(tlora.apply_lora_delta(ab, x, lspec), plain)
    key = tlora.DropoutKey((0,), 2).at(0, "q")
    dropped = tlora.apply_lora_delta(ab, x, lspec, rng=key)
    assert not torch.allclose(dropped, plain)
    assert torch.equal(dropped, tlora.apply_lora_delta(ab, x, lspec, rng=key))
