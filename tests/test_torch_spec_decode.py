"""The port's exact speculative decode (tst_torch.models.spec_decode) against
its own greedy decode and against tst.models.spec_decode.

The cases follow tests/test_spec_decode.py: a self draft, an unrelated
draft, a perturbed draft, gamma in {1, 2, 4}, a smaller draft geometry,
LoRA on the target, max_new=1, and both refusals. Weights are the JAX
``init_params`` carried across by tst_torch.bridge; prompts from a numpy
seed; f32 on the CPU. Tokens must be equal (to the port's greedy decode
and to tst's speculative output), and so must ``rounds`` and ``committed``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.data.tokenize import ByteTokenizer
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.models import spec_decode as jspec
from tst.train import infer as jinfer
from tst_torch import bridge
from tst_torch.models import decode as tdecode
from tst_torch.models import lora as tlora
from tst_torch.models import spec_decode as tspec
from tst_torch.models.spec import ModelSpec
from tst_torch.train import infer as tinfer

TINY = jdec.spec_by_name("tiny", dtype=jnp.float32)
SMALL_DRAFT = jdec.spec_by_name("tiny", dtype=jnp.float32, n_layers=1, n_heads=2,
                                n_kv_heads=1, d_ff=64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _params(seed, spec=TINY):
    return jax.tree.map(np.asarray, jdec.init_params(jax.random.key(seed), spec))


def _perturbed(params, seed=3, scale=0.02):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (p + scale * rng.normal(size=p.shape)).astype(p.dtype), params)


def _prompts(seed, b=3, s=64, vocab=250):
    rng = np.random.default_rng(seed)
    tokens = np.full((b, s), 256, np.int32)
    plen = rng.integers(8, 34, size=b).astype(np.int32)
    for i, n in enumerate(plen):
        tokens[i, :n] = rng.integers(0, vocab, size=n)
    return tokens, plen


def _lora(seed=1):
    lspec = jlora.LoraSpec(rank=4, dtype=jnp.float32)
    lora = jax.tree.map(np.asarray, jlora.init_lora(jax.random.key(seed), TINY, lspec))
    rng = np.random.default_rng(seed)
    for ab in lora.values():
        ab["b"] = (0.1 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    return lora, lspec, tlora.LoraSpec(rank=4, dtype=torch.float32)


def _both(draft, dspec, params, tokens, plen, max_new, gamma, lora=None):
    """(port tokens, port stats, port greedy tokens, tst tokens, tst stats)."""
    jl, jls, tls = lora if lora is not None else (None, None, None)
    want, wstats = jspec.speculative_greedy_decode(
        jax.tree.map(jnp.asarray, draft), dspec, jax.tree.map(jnp.asarray, params), TINY,
        jnp.asarray(tokens), jnp.asarray(plen), max_new, gamma=gamma,
        lora=None if jl is None else jax.tree.map(jnp.asarray, jl), lora_spec=jls,
        return_stats=True)
    tl = None if jl is None else bridge.to_torch(jl)
    tparams = bridge.to_torch(params)
    got, stats = tspec.speculative_greedy_decode(
        bridge.to_torch(draft), _port(dspec), tparams, _port(TINY), torch.from_numpy(tokens),
        torch.from_numpy(plen), max_new, gamma=gamma, lora=tl, lora_spec=tls,
        use_pallas=True, return_stats=True)
    greedy = tdecode.greedy_decode(tparams, torch.from_numpy(tokens), torch.from_numpy(plen),
                                   max_new, _port(TINY), lora=tl, lora_spec=tls,
                                   use_pallas=True)
    return got, stats, greedy, np.asarray(want), wstats


def _check(got, stats, greedy, want, wstats, max_new):
    assert got.dtype == torch.int32 and tuple(got.shape) == (want.shape[0], max_new)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    assert stats["rounds"] == int(wstats["rounds"])
    np.testing.assert_array_equal(stats["committed"].numpy(), np.asarray(wstats["committed"]))


CASES = {
    # draft == target: every round accepts all gamma proposals
    "self": (lambda p: p, TINY, 13, 3),
    "unrelated": (lambda p: _params(7), TINY, 9, 4),
    "perturbed": (_perturbed, TINY, 12, 3),
    "gamma1": (lambda p: _params(11), TINY, 7, 1),
    "gamma2": (lambda p: _params(11), TINY, 7, 2),
    "gamma4": (lambda p: _params(11), TINY, 7, 4),
    "smaller_draft": (lambda p: _params(5, SMALL_DRAFT), SMALL_DRAFT, 8, 4),
    "max_new_1": (lambda p: p, TINY, 1, 3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_speculative_equals_greedy_and_reference(case):
    make_draft, dspec, max_new, gamma = CASES[case]
    params = _params(0)
    tokens, plen = _prompts(sorted(CASES).index(case))
    out = _both(make_draft(params), dspec, params, tokens, plen, max_new, gamma)
    _check(*out, max_new)
    stats = out[1]
    if case == "self":  # the ideal round count, ceil((max_new - 1) / (gamma + 1))
        assert stats["rounds"] == -(-(max_new - 1) // (gamma + 1))
    if case == "max_new_1":
        assert stats["rounds"] == 0
    assert int(stats["committed"].min()) >= max_new


def test_lora_on_target():
    """The verify chunk carries the target's adapter; the draft stays base."""
    params = _params(0)
    tokens, plen = _prompts(5)
    _check(*_both(_params(13), TINY, params, tokens, plen, 6, 2, lora=_lora()), 6)


def test_fold_stacked_lora_equals_per_fold():
    """Fold-major rows [k·B] with a fold-stacked adapter: each fold block
    equal to that fold's single-adapter run."""
    params, draft = _params(0), _params(13)
    tokens, plen = _prompts(6, b=4)
    loras = [_lora(seed) for seed in (1, 2)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *[lo[0] for lo in loras])
    tls = loras[0][2]
    got = tspec.speculative_greedy_decode(
        bridge.to_torch(draft), _port(TINY), bridge.to_torch(params), _port(TINY),
        torch.from_numpy(tokens), torch.from_numpy(plen), 6, gamma=2,
        lora=bridge.to_torch(stacked), lora_spec=tls)
    for f, (lo, _, _) in enumerate(loras):
        rows = slice(2 * f, 2 * f + 2)
        want = tdecode.greedy_decode(bridge.to_torch(params), torch.from_numpy(tokens[rows]),
                                     torch.from_numpy(plen[rows]), 6, _port(TINY),
                                     lora=bridge.to_torch(lo), lora_spec=tls)
        np.testing.assert_array_equal(got[rows].numpy(), want.numpy())


def test_draft_vocab_wider_than_target_refused():
    wide = jdec.spec_by_name("tiny", dtype=jnp.float32, vocab_size=512)
    tokens, plen = _prompts(7)
    with pytest.raises(ValueError, match="vocab"):
        tspec.speculative_greedy_decode(
            bridge.to_torch(_params(5, wide)), _port(wide), bridge.to_torch(_params(0)),
            _port(TINY), torch.from_numpy(tokens), torch.from_numpy(plen), 4)


def test_gamma_zero_refused():
    params = bridge.to_torch(_params(0))
    tokens, plen = _prompts(8)
    with pytest.raises(ValueError, match="gamma"):
        tspec.speculative_greedy_decode(params, _port(TINY), params, _port(TINY),
                                        torch.from_numpy(tokens), torch.from_numpy(plen), 4,
                                        gamma=0)


@pytest.mark.parametrize("kind", ["numeric", "open"])
def test_heldout_legs_with_draft_match_reference(kind):
    """The held-out numeric and open legs with ``draft=(dspec, dparams),
    gamma``: fold-stacked adapters on the target, a smaller base-weighted
    draft; equal to tst's, and to the port's legs without a draft."""
    params = _params(0)
    dspec = jdec.spec_by_name("small", dtype=jnp.float32)
    dparams = _params(5, dspec)
    k, n = 2, 10
    lspec = jlora.LoraSpec(rank=4, alpha=8.0, targets=("q_proj", "v_proj"), dtype=jnp.float32)
    tls = tlora.LoraSpec(rank=4, alpha=8.0, targets=("q_proj", "v_proj"), dtype=torch.float32)
    lora_k = jax.tree.map(lambda *xs: np.stack(xs) + np.float32(0.02), *[
        jax.tree.map(np.asarray, jlora.init_lora(key, TINY, lspec))
        for key in jax.random.split(jax.random.key(7), k)])
    tokens, plen = _prompts(9, b=n)
    rng = np.random.default_rng(0)
    fold_id = np.asarray([i % k for i in range(n)], np.int32)
    tok = ByteTokenizer()
    if kind == "numeric":
        gold = rng.uniform(1, 9, size=n).astype(np.float64)
        jfn, tfn = jinfer.score_heldout_numeric, tinfer.score_heldout_numeric
    else:
        gold = ["ab" if i % 3 else None for i in range(n)]
        jfn, tfn = jinfer.score_heldout_open, tinfer.score_heldout_open
    want = jfn(jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, lora_k), TINY,
               lspec, jnp.asarray(tokens), jnp.asarray(plen - 1), gold, fold_id, k,
               tokenizer=tok, max_new=8, draft=(dspec, jax.tree.map(jnp.asarray, dparams)),
               gamma=2)
    targs = (bridge.to_torch(params), bridge.to_torch(lora_k), _port(TINY), tls,
             torch.from_numpy(tokens), torch.from_numpy(plen - 1), gold, fold_id, k)
    got = tfn(*targs, tokenizer=tok, max_new=8,
              draft=(_port(dspec), bridge.to_torch(dparams)), gamma=2)
    plain = tfn(*targs, tokenizer=tok, max_new=8)
    for g, w, p in zip(got, want, plain):
        if kind == "open" and isinstance(w, list):
            assert g == w == p
        else:
            np.testing.assert_array_equal(np.nan_to_num(g, nan=-1), np.nan_to_num(w, nan=-1))
            np.testing.assert_array_equal(np.nan_to_num(g, nan=-1), np.nan_to_num(p, nan=-1))


def test_decode_chunk_rows_with_draft_matches_reference():
    spec = dataclasses.replace(TINY, n_layers=24, dtype=jnp.bfloat16)
    dspec = dataclasses.replace(SMALL_DRAFT, dtype=jnp.bfloat16)
    tspec_, tdspec = (ModelSpec(**{**dataclasses.asdict(s), "dtype": torch.bfloat16})
                      for s in (spec, dspec))
    for k, base in ((1, None), (2, 10 ** 9), (5, 4 * 10 ** 9)):
        assert tinfer.decode_chunk_rows(tspec_, 512, 12, k, base_bytes=base,
                                        draft_spec=tdspec) == \
            jinfer.decode_chunk_rows(spec, 512, 12, k, base_bytes=base, draft_spec=dspec)
