"""KV-cached greedy decode of the port (tst_torch.models.decode) and the
held-out decode scorers (tst_torch.train.infer) against the JAX package.

Weights are the JAX ``init_params`` (plain, or int4 with int8 embed/head)
and adapters the JAX ``init_lora`` with B drawn nonzero, carried across by
tst_torch.bridge; prompts and numbers come from numpy seeds. f32 on the
CPU, where the reference takes its non-Pallas path (qdot) and the port's
int4 projections take the K3 wrapper's plain version. Greedy tokens must be
equal; caches and logits agree within 1e-5 of their scale (f32 sums in
another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.data.tokenize import ByteTokenizer
from tst.models import decode as jdecode
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import infer as jinfer
from tst_torch import bridge
from tst_torch.models import decode as tdecode
from tst_torch.models import decoder as tdec
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec
from tst_torch.train import infer as tinfer

#: every layer matrix of this geometry takes int4 (input dims multiples of
#: 128); QKV biases and a tied head, as Qwen2.5
WIDE = dataclasses.replace(jdec.spec_by_name("tiny"), name="wide", d_model=128, n_heads=4,
                           n_kv_heads=2, d_head=32, d_ff=256, qkv_bias=True,
                           dtype=jnp.float32)
JLSPEC = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
TLSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
K = 2


def _port_spec(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _params(quant):
    params = jdec.init_params(jax.random.key(11), WIDE, quantize=quant is not None,
                              bits=quant or 8)
    # random biases, so the bias path carries numbers
    rng = np.random.default_rng(12)
    for key in ("bq", "bk", "bv"):
        params["layers"][key] = jnp.asarray(
            0.1 * rng.normal(size=params["layers"][key].shape), jnp.float32)
    return params, bridge.to_torch(jax.tree.map(np.asarray, params))


def _fold_adapters(seed=0):
    """K JAX adapters stacked on a fold axis (numpy tree), B nonzero."""
    rng = np.random.default_rng(seed)
    loras = [jax.tree.map(np.asarray, jlora.init_lora(key, WIDE, JLSPEC))
             for key in jax.random.split(jax.random.key(seed), K)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *loras)
    for ab in stacked.values():
        ab["b"] = (0.2 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    return stacked


def _prompts(b, s=48, seed=3):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, (b, s)).astype(np.int32)
    prompt_len = rng.integers(s // 3, s + 1, b).astype(np.int32)
    for i, n in enumerate(prompt_len):
        tokens[i, n:] = 0  # right padding
    return tokens, prompt_len


@pytest.mark.parametrize("quant", [None, 4])
@pytest.mark.parametrize("with_lora", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_greedy_decode_matches_reference(quant, with_lora, use_pallas):
    """Fold-major rows [K·B] through the fold-stacked adapter against the
    reference run per fold with that fold's adapter."""
    params, tparams = _params(quant)
    tokens, prompt_len = _prompts(K * 3)
    stacked = _fold_adapters() if with_lora else None
    want = []
    for f in range(K):
        rows = slice(3 * f, 3 * f + 3)
        lora = jax.tree.map(lambda a, _f=f: jnp.asarray(a[_f]), stacked) if with_lora else None
        want.append(np.asarray(jdecode.greedy_decode(
            params, jnp.asarray(tokens[rows]), jnp.asarray(prompt_len[rows]), 6, WIDE,
            lora=lora, lora_spec=JLSPEC if with_lora else None)))
    got = tdecode.greedy_decode(
        tparams, torch.from_numpy(tokens), torch.from_numpy(prompt_len), 6, _port_spec(WIDE),
        lora=bridge.to_torch(stacked) if with_lora else None,
        lora_spec=TLSPEC if with_lora else None, use_pallas=use_pallas)
    assert got.dtype == torch.int32 and got.shape == (K * 3, 6)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want))


def test_return_kv_and_chunk_step_match_reference():
    """The prefill's post-RoPE K/V, then one T=3 chunk step (the general-T
    step speculative decode verifies with) at a shared slot: greedy tokens
    equal, caches within 1e-5."""
    params, tparams = _params(4)
    spec = _port_spec(WIDE)
    tokens, prompt_len = _prompts(3, s=32)
    h, k_all, v_all = jdec.apply_model(params, jnp.asarray(tokens), WIDE, return_kv=True)
    th, tk, tv = tdec.apply_model(tparams, torch.from_numpy(tokens), spec, return_kv=True)
    for got, want in ((th, h), (tk, k_all), (tv, v_all)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * np.abs(np.asarray(want)).max())
    s_max = 64
    pad = ((0, 0), (0, 0), (0, s_max - 32), (0, 0), (0, 0))
    jk, jv = jnp.pad(k_all, pad), jnp.pad(v_all, pad)
    chunk = np.random.default_rng(4).integers(0, 256, (3, 3)).astype(np.int32)
    pos = prompt_len[:, None] + np.arange(3, dtype=np.int32)[None]
    valid = np.arange(s_max)[None, :] < prompt_len[:, None]
    want_tok, want_k, want_v = jdecode._chunk_step(
        params, None, None, WIDE, jnp.asarray(chunk), jnp.asarray(pos), 32,
        jnp.asarray(valid), jk, jv)
    tk_c = torch.from_numpy(np.array(jk))
    tv_c = torch.from_numpy(np.array(jv))
    got_tok, got_k, got_v = tdecode._chunk_step(
        tparams, None, None, spec, torch.from_numpy(chunk), torch.from_numpy(pos), 32,
        torch.from_numpy(valid), tk_c, tv_c, use_pallas=True)
    assert got_k is tk_c and got_v is tv_c  # written in place
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    for got, want in ((got_k, want_k), (got_v, want_v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5 * np.abs(np.asarray(want)).max())


def test_pad_to_too_small_raises():
    _, tparams = _params(None)
    tokens, prompt_len = _prompts(2, s=16)
    with pytest.raises(ValueError, match="pad_to"):
        tdecode.greedy_decode(tparams, torch.from_numpy(tokens), torch.from_numpy(prompt_len),
                              8, _port_spec(WIDE), pad_to=20)


def test_decode_text_and_numeric_match_reference():
    tok = ByteTokenizer()
    rows = [tok.encode(" 12.5 m") + [tok.eos_id, 50, 51], tok.encode("about 1,024") + [300],
            tok.encode("-3 and 4"), [300, 301] + tok.encode("x") + [tok.eos_id],
            tok.encode("none")]
    width = max(len(r) for r in rows)
    gen = np.array([r + [tok.eos_id] * (width - len(r)) for r in rows], np.int32)
    assert tdecode.decode_text(gen, tok) == jdecode.decode_text(gen, tok)
    np.testing.assert_array_equal(tdecode.decode_numeric(gen, tok),
                                  jdecode.decode_numeric(gen, tok))


@pytest.mark.parametrize("n_layers,quant", [(2, None), (24, None), (24, 4)])
def test_decode_chunk_rows_matches_reference(n_layers, quant):
    spec = dataclasses.replace(WIDE, n_layers=n_layers, dtype=jnp.bfloat16)
    tspec = ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.bfloat16})
    base = 10 ** 9 if quant else None
    for k in (1, 2, 5):
        assert tinfer.decode_chunk_rows(tspec, 512, 12, k, base_bytes=base) == \
            jinfer.decode_chunk_rows(spec, 512, 12, k, base_bytes=base)


@pytest.mark.parametrize("quant", [None, 4])
def test_heldout_numeric_and_open_match_reference(quant):
    """Held-out decode with each row's fold adapter, chunks of 2 rows per
    fold: the same predictions, per-sample MRA and exact-match scores."""
    params, tparams = _params(quant)
    tok = ByteTokenizer()
    n = 9
    tokens, prompt_len = _prompts(n, s=40, seed=5)
    answer_pos = prompt_len - 1
    rng = np.random.default_rng(6)
    fold_id = rng.integers(0, K, n).astype(np.int32)
    gold_values = np.where(rng.random(n) < 0.6, rng.integers(1, 50, n), np.nan).astype(np.float32)
    gold_texts = [None if np.isfinite(v) else "ab" for v in gold_values]
    stacked = _fold_adapters(seed=7)
    jl = jax.tree.map(jnp.asarray, stacked)
    tl = bridge.to_torch(stacked)
    args_j = (params, jl, WIDE, JLSPEC, jnp.asarray(tokens), jnp.asarray(answer_pos))
    args_t = (tparams, tl, _port_spec(WIDE), TLSPEC, torch.from_numpy(tokens),
              torch.from_numpy(answer_pos))
    want = jinfer.score_heldout_numeric(*args_j, gold_values, fold_id, K, tokenizer=tok,
                                        max_new=5)
    got = tinfer.score_heldout_numeric(*args_t, gold_values, fold_id, K, tokenizer=tok,
                                       max_new=5, use_pallas=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    want_rows = jinfer._decode_heldout_rows(*args_j, np.arange(n), fold_id, K, 5, False,
                                            chunk=2)
    got_rows = tinfer._decode_heldout_rows(*args_t, np.arange(n), fold_id, K, 5, True,
                                           chunk=2)
    for g, w in zip(got_rows, want_rows):
        np.testing.assert_array_equal(g, w)
    want_o = jinfer.score_heldout_open(*args_j, gold_texts, fold_id, K, tokenizer=tok,
                                       max_new=4)
    got_o = tinfer.score_heldout_open(*args_t, gold_texts, fold_id, K, tokenizer=tok,
                                      max_new=4)
    assert got_o[0] == want_o[0]
    np.testing.assert_array_equal(got_o[1], want_o[1])


def test_speculative_decode_legs_match_plain():
    """The held-out numeric leg with a draft (``draft=(spec, params)``) on an
    int4 base, fold-stacked adapters, the verify chunk's int4 projections
    through the K3 wrapper's plain version: the plain leg's predictions."""
    _, tparams = _params(4)
    _, dparams = _params(None)
    tokens, prompt_len = _prompts(2 * K, s=16)
    args = (tparams, bridge.to_torch(_fold_adapters(seed=9)), _port_spec(WIDE), TLSPEC,
            torch.from_numpy(tokens), torch.from_numpy(prompt_len - 1),
            np.ones(2 * K, np.float32), np.arange(2 * K, dtype=np.int32) % K, K)
    kw = dict(tokenizer=ByteTokenizer(), max_new=6, use_pallas=True)
    want = tinfer.score_heldout_numeric(*args, **kw)
    got = tinfer.score_heldout_numeric(*args, draft=(_port_spec(WIDE), dparams), gamma=3, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
