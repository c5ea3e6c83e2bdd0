"""The port's multi-token MCQ scorer against
tst.train.infer.make_mcq_scorer_multitoken, the fallback for tokenizers
whose option letters are not single tokens.

The tokens come from a byte-level BPE without letter merges (" A" is two
tokens), through both packages' HFTokenizer; weights are the JAX
``init_params`` and fold-stacked adapters the JAX ``FoldTrainer.init_state``
with B drawn nonzero, carried across by tst_torch.bridge. f32 on the CPU.
Tolerance: 1e-4 on summed log-probs (f32 sums in another order over a
vocabulary of 259) and 1e-5 on the letter probabilities.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_host import bpe_tokenizer_dir
from tst.data.adapters import load_benchmark as jload
from tst.data.tokenize import HFTokenizer as JHF
from tst.data.tokenize import tokenize_dataset as jtokenize
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import infer as jinfer
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch.data.adapters import load_benchmark as tload
from tst_torch.data.tokenize import HFTokenizer as THF
from tst_torch.data.tokenize import tokenize_dataset as ttokenize
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec
from tst_torch.train import infer as tinfer

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
PORT_TINY = ModelSpec(**{**dataclasses.asdict(TINY), "dtype": torch.float32})
JLSPEC = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
TLSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
K = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(tokenized set, JAX base params, fold-stacked JAX adapters)."""
    path = bpe_tokenizer_dir(tmp_path_factory.mktemp("bpe"), letter_merges=False)
    tb = ttokenize(tload("synthetic:0.5", n=20, seed=0), THF(path))
    jtb = jtokenize(jload("synthetic:0.5", n=20, seed=0), JHF(path))
    np.testing.assert_array_equal(tb.tokens, jtb.tokens)
    np.testing.assert_array_equal(tb.option_token_seqs, jtb.option_token_seqs)
    assert tb.option_token_seqs.shape[1] == 2 and (tb.option_token_seqs >= 0).all()
    params = jdec.init_params(jax.random.key(0), TINY)
    lora, _ = jsft.FoldTrainer(TINY, JLSPEC, K).init_state(jax.random.key(1))
    rng = np.random.default_rng(2)
    lora = jax.tree.map(np.asarray, lora)
    for ab in lora.values():
        ab["b"] = (0.05 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    return tb, jax.tree.map(np.asarray, params), lora


def _fold_ids(n):
    return (np.arange(n) % K).astype(np.int32)


@pytest.mark.parametrize("with_lora", [False, True])
def test_multitoken_scorer_matches_reference(data, with_lora):
    """Held-out summed log-probs, fold f's rows through fold f's adapter,
    and the letter probabilities of score_heldout_mcq's dispatch."""
    tb, params, lora = data
    k = K if with_lora else 1
    fold_id = _fold_ids(tb.n) if with_lora else np.zeros(tb.n, np.int32)
    idx, valid = jinfer.heldout_index_grid(fold_id, k)
    jl = jax.tree.map(jnp.asarray, lora) if with_lora else None
    tl = bridge.to_torch(lora) if with_lora else None
    lspec = (JLSPEC, TLSPEC) if with_lora else (None, None)
    want = np.asarray(jinfer.make_mcq_scorer_multitoken(TINY, lspec[0])(
        jax.tree.map(jnp.asarray, params), jl, jnp.asarray(tb.tokens),
        jnp.asarray(tb.answer_pos), jnp.asarray(tb.option_token_seqs), jnp.asarray(idx)))
    base = bridge.to_torch(params)
    tokens, pos = torch.from_numpy(tb.tokens), torch.from_numpy(tb.answer_pos)
    got = tinfer.make_mcq_scorer_multitoken(PORT_TINY, lspec[1])(
        base, tl, tokens, pos, tb.option_token_seqs, idx).numpy()
    assert got.shape == want.shape == (k, idx.shape[1], tb.option_token_seqs.shape[0])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    probs = tinfer.score_heldout_mcq(base, tl, PORT_TINY, lspec[1], tokens, pos,
                                     tb.option_token_ids, tb.n_options, fold_id, k,
                                     option_seqs=tb.option_token_seqs)
    jprobs = jinfer.score_heldout_mcq(jax.tree.map(jnp.asarray, params), jl, TINY, lspec[0],
                                      jnp.asarray(tb.tokens), jnp.asarray(tb.answer_pos),
                                      tb.option_token_ids, tb.n_options, fold_id, k,
                                      option_seqs=tb.option_token_seqs)
    np.testing.assert_allclose(probs, jprobs, atol=1e-5)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)


def test_option_that_does_not_fit_scores_minus_1e30(data):
    """Rows whose answer marker sits near the end of the sequence: an option
    whose real tokens would run past it gets -1e30 in both packages, a
    one-token option still scores; the attention kernel's plain version
    (use_pallas) gives the dense path's numbers."""
    _, params, _ = data
    rng = np.random.default_rng(3)
    n, s = 6, 64
    tokens = rng.integers(3, 259, size=(n, s)).astype(np.int32)
    pos = np.array([10, s - 2, s - 3, s - 4, 30, s - 2], np.int32)
    opt = np.array([[40, -1, -1], [41, 42, -1], [43, 44, 45], [41, 46, 47]], np.int32)
    idx = np.arange(n, dtype=np.int32)[None]
    want = np.asarray(jinfer.make_mcq_scorer_multitoken(TINY)(
        jax.tree.map(jnp.asarray, params), None, jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(opt), jnp.asarray(idx)))
    base = bridge.to_torch(params)
    for use_pallas in (False, True):
        got = tinfer.make_mcq_scorer_multitoken(PORT_TINY, use_pallas=use_pallas)(
            base, None, torch.from_numpy(tokens), torch.from_numpy(pos), opt, idx).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    fits = want[0] > -1e29  # at pos = s - 2 only the first two tokens fit
    assert fits[[1, 5]].tolist() == [[True, True, False, False]] * 2
    assert fits[[0, 2, 3, 4]].all()
