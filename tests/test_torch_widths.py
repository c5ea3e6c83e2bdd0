"""The six model widths the port defines beside Qwen2.5-0.5B and Llama-3-8B
(Qwen2.5-1.5B, -3B, -7B, Llama-3.1-8B, Llama-3.2-1B, -3B) against
tst.models on the same inputs, and the reference's serving pair.

(a) Each width's published HF ``config.json`` read by the port's and by
tst's ``spec_from_hf_config`` gives ``spec_by_name(width)``.
(b) Each width narrowed to 2 layers, vocab 384, d_model 64 and 1-2 KV heads,
keeping its d_head, GQA group, QKV bias, tie, ``rope_theta``, ``rms_eps``
and ``rope_scaling``: the port's ``apply_model`` (plain, and
``use_pallas=True`` through the kernel wrapper's CPU path) against tst's at
atol=rtol=1e-4 (tests/test_torch_decoder.py's tolerance), and one
fold-parallel LoRA step's fold losses and adapter gradients against tst's
FoldTrainer (its jitted step's losses; its loss function's gradients) in f32.
(c) Speculative decode with a narrowed Llama-3.2-1B-shaped draft (D=64,
group 4, x32 llama3 RoPE scaling, tied head) for a narrowed
Llama-3-8B-shaped target (D=128, group 4, untied, unscaled) gives tst's
``greedy_decode`` tokens, at gamma 2 and 4: with unrelated random weights
(every draft token rejected, as on the card), and with a pair made to agree
(every draft token accepted) or to agree in part (rows accept different
prefixes, and the target's cache is rolled back to them).

Weights are the JAX ``init_params`` carried across by tst_torch.bridge (or
through numpy); inputs come from numpy seeds. Everything runs in f32 on the
CPU, the JAX side through its plain reference (use_pallas=False).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.models import decode as jdecode
from tst.models import decoder as jdec
from tst.models import hf_load as jhf
from tst.models import lora as jlora
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch.models import decode as tdecode
from tst_torch.models import decoder as tdec
from tst_torch.models import hf_load as thf
from tst_torch.models import lora as tlora
from tst_torch.models import spec_decode as tspec
from tst_torch.models.spec import ModelSpec, spec_by_name
from tst_torch.train import sft as tsft

_LLAMA = {"architectures": ["LlamaForCausalLM"], "attention_bias": False,
          "attention_dropout": 0.0, "bos_token_id": 128000, "eos_token_id": 128001,
          "hidden_act": "silu", "initializer_range": 0.02, "max_position_embeddings": 131072,
          "mlp_bias": False, "model_type": "llama", "pretraining_tp": 1, "rms_norm_eps": 1e-05,
          "rope_theta": 500000.0, "torch_dtype": "bfloat16", "use_cache": True,
          "vocab_size": 128256}
_QWEN = {"architectures": ["Qwen2ForCausalLM"], "attention_dropout": 0.0,
         "bos_token_id": 151643, "eos_token_id": 151645, "hidden_act": "silu",
         "initializer_range": 0.02, "max_position_embeddings": 32768, "model_type": "qwen2",
         "rms_norm_eps": 1e-06, "rope_theta": 1000000.0, "torch_dtype": "bfloat16",
         "use_cache": True, "use_sliding_window": False}

#: the published config.json of each width (the Qwen2.5 Instruct releases,
#: meta-llama's Llama-3.1-8B, Llama-3.2-1B and -3B)
CONFIGS = {
    "qwen2.5-1.5b": {**_QWEN, "hidden_size": 1536, "intermediate_size": 8960,
                     "max_window_layers": 21, "num_attention_heads": 12,
                     "num_hidden_layers": 28, "num_key_value_heads": 2,
                     "sliding_window": 32768, "tie_word_embeddings": True,
                     "vocab_size": 151936},
    "qwen2.5-3b": {**_QWEN, "hidden_size": 2048, "intermediate_size": 11008,
                   "max_window_layers": 70, "num_attention_heads": 16,
                   "num_hidden_layers": 36, "num_key_value_heads": 2,
                   "sliding_window": 32768, "tie_word_embeddings": True,
                   "vocab_size": 151936},
    "qwen2.5-7b": {**_QWEN, "hidden_size": 3584, "intermediate_size": 18944,
                   "max_window_layers": 28, "num_attention_heads": 28,
                   "num_hidden_layers": 28, "num_key_value_heads": 4,
                   "sliding_window": 131072, "tie_word_embeddings": False,
                   "vocab_size": 152064},
    "llama3.1-8b": {**_LLAMA, "hidden_size": 4096, "intermediate_size": 14336,
                    "num_attention_heads": 32, "num_hidden_layers": 32,
                    "num_key_value_heads": 8, "tie_word_embeddings": False,
                    "rope_scaling": {"factor": 8.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192,
                                     "rope_type": "llama3"}},
    "llama3.2-1b": {**_LLAMA, "head_dim": 64, "hidden_size": 2048, "intermediate_size": 8192,
                    "num_attention_heads": 32, "num_hidden_layers": 16,
                    "num_key_value_heads": 8, "tie_word_embeddings": True,
                    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192,
                                     "rope_type": "llama3"}},
    "llama3.2-3b": {**_LLAMA, "head_dim": 128, "hidden_size": 3072, "intermediate_size": 8192,
                    "num_attention_heads": 24, "num_hidden_layers": 28,
                    "num_key_value_heads": 8, "tie_word_embeddings": True,
                    "rope_scaling": {"factor": 32.0, "low_freq_factor": 1.0,
                                     "high_freq_factor": 4.0,
                                     "original_max_position_embeddings": 8192,
                                     "rope_type": "llama3"}},
}
WIDTHS = sorted(CONFIGS)
#: the fields a ModelSpec takes from config.json (name, dtype and
#: max_seq_len aside: max_seq_len is the config's max_position_embeddings)
GEOMETRY = ("vocab_size", "d_model", "n_layers", "n_heads", "n_kv_heads", "d_head", "d_ff",
            "rope_theta", "rms_eps", "qkv_bias", "tie_embeddings", "rope_scaling")

JLSPEC = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
TLSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def narrowed(name):
    """tst's spec of ``name`` cut to 2 layers, vocab 384, d_model 64 and
    d_ff 96, with one KV head where its GQA group is above 4 and two where
    it is 4 or less (H = group · KVH); d_head, QKV bias, tie, rope_theta,
    rms_eps and rope_scaling kept; f32."""
    ref = jdec.spec_by_name(name)
    group = ref.n_heads // ref.n_kv_heads
    kvh = 1 if group > 4 else 2
    return dataclasses.replace(ref, name=f"narrow-{name}", vocab_size=384, d_model=64,
                               n_layers=2, n_heads=group * kvh, n_kv_heads=kvh, d_ff=96,
                               dtype=jnp.float32)


def _port(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _params(spec, seed=0):
    """tst's init_params as numpy, with nonzero QKV biases and norm weights
    away from 1."""
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(seed), spec))
    rng = np.random.default_rng(seed)
    for key in ("bq", "bk", "bv", "attn_norm", "mlp_norm"):
        if key in params["layers"]:
            shape = params["layers"][key].shape
            base = 1.0 if key.endswith("norm") else 0.0
            params["layers"][key] = (base + 0.2 * rng.normal(size=shape)).astype(np.float32)
    return params


@pytest.mark.parametrize("name", WIDTHS)
def test_published_config_gives_the_named_spec(name, tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(CONFIGS[name]))
    want = spec_by_name(name)
    for got in (thf.spec_from_hf_config(str(tmp_path), name=name),
                jhf.spec_from_hf_config(str(tmp_path), name=name)):
        for field in GEOMETRY:
            assert getattr(got, field) == getattr(want, field), (name, field)
        assert got.max_seq_len == CONFIGS[name]["max_position_embeddings"]
    assert dataclasses.replace(thf.spec_from_hf_config(str(tmp_path), name=name),
                               max_seq_len=want.max_seq_len) == want


def test_narrowed_specs_keep_each_width_s_shape():
    for name in WIDTHS:
        ref, spec = jdec.spec_by_name(name), narrowed(name)
        assert spec.n_heads // spec.n_kv_heads == ref.n_heads // ref.n_kv_heads
        assert spec.n_kv_heads in (1, 2) and spec.n_layers == 2 and spec.vocab_size == 384
        for field in ("d_head", "qkv_bias", "tie_embeddings", "rope_theta", "rms_eps",
                      "rope_scaling"):
            assert getattr(spec, field) == getattr(ref, field), (name, field)


@pytest.mark.parametrize("name", WIDTHS)
def test_narrowed_forward_matches_reference(name):
    spec = narrowed(name)
    params = _params(spec)
    tokens = np.random.default_rng(2).integers(0, spec.vocab_size, (2, 64)).astype(np.int32)
    want = np.asarray(jdec.apply_model(params, jnp.asarray(tokens), spec))
    tp, ts = bridge.to_torch(params), _port(spec)
    for use_pallas in (False, True):  # True: the kernel wrapper's CPU (plain) path
        got = tdec.apply_model(tp, torch.from_numpy(tokens), ts, use_pallas=use_pallas)
        assert got.shape == (2, 64, spec.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def data():
    """(tokens, loss_mask, answer_pos, t_max) of 12 synthetic MCQ rows."""
    tb = tokenize_dataset(load_benchmark("synthetic:0.5", n=12, seed=0), ByteTokenizer())
    return tb.tokens, tb.loss_mask, tb.answer_pos, int(np.max(tb.lengths - tb.answer_pos - 1))


@pytest.mark.parametrize("name", WIDTHS)
def test_narrowed_fold_step_matches_reference(name, data):
    """One fold-parallel step, 2 folds x 3 rows, from the same weights, LoRA
    A (tst's FoldTrainer.init_state) with B drawn nonzero, and batches:
    tst's jitted step's per-fold losses and the gradients of its loss
    function per fold (jax.value_and_grad of sft_loss_window) against the
    port's FoldTrainer (loss_and_grads, plain and through the CPU wrapper;
    its step's losses): atol 1e-5 on the losses, 1e-5 + 1e-4 relative on
    the gradients (f32 sums in another order through a 2-layer model)."""
    tokens, mask, pos, t_max = data
    spec = narrowed(name)
    params = _params(spec)
    k, b = 2, 3
    jtrainer = jsft.FoldTrainer(spec, JLSPEC, k, t_max=t_max)
    lora, _ = jtrainer.init_state(jax.random.key(1))
    lora = jax.tree.map(np.asarray, lora)
    rng = np.random.default_rng(1)
    for ab in lora.values():
        ab["b"] = (0.1 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    idx = np.arange(k * b, dtype=np.int32).reshape(k, b)
    jparams = jax.tree.map(jnp.asarray, params)
    _, opt = jtrainer.init_state(jax.random.key(1))
    _, _, jlosses = jtrainer._step_fn(jparams, jax.tree.map(jnp.asarray, lora), opt,
                                      jnp.asarray(tokens), jnp.asarray(mask), jnp.asarray(pos),
                                      jnp.asarray(idx))
    want_grads = []
    for f in range(k):
        rows = idx[f]
        _, grads = jax.value_and_grad(jsft.sft_loss_window, argnums=1)(
            jparams, jax.tree.map(lambda x: jnp.asarray(x[f]), lora), jnp.asarray(tokens[rows]),
            jnp.asarray(mask[rows]), jnp.asarray(pos[rows]), t_max, spec, JLSPEC)
        want_grads.append(jax.tree.map(np.asarray, grads))
    want_grads = jax.tree.map(lambda *xs: np.stack(xs), *want_grads)

    tp, tl = bridge.to_torch(params), bridge.to_torch(lora)
    shape = (k, b, tokens.shape[1])
    targs = (torch.from_numpy(tokens[: k * b]).reshape(shape),
             torch.from_numpy(mask[: k * b]).reshape(shape),
             torch.from_numpy(pos[: k * b]).reshape(k, b))
    for use_pallas in (False, True):
        trainer = tsft.FoldTrainer(_port(spec), TLSPEC, k, use_pallas=use_pallas, t_max=t_max)
        losses, grads = trainer.loss_and_grads(tp, tl, *targs)
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=1e-5)
        for g, w in zip(tsft.tree_leaves(grads), tsft.tree_leaves(want_grads)):
            np.testing.assert_allclose(g.detach().numpy(), w, atol=1e-5, rtol=1e-4)
    _, opt_t = trainer.init_state(torch.Generator().manual_seed(0))
    _, _, step_losses = trainer.step(
        tp, bridge.to_torch(lora), opt_t, torch.from_numpy(tokens), torch.from_numpy(mask),
        torch.from_numpy(pos), idx)
    np.testing.assert_allclose(step_losses.numpy(), np.asarray(jlosses), atol=1e-5)


#: the reference's serving pair, narrowed: a Llama-3-8B-shaped target and a
#: Llama-3.2-1B-shaped draft over one vocabulary
PAIR_TARGET = dataclasses.replace(
    jdec.spec_by_name("llama3-8b"), name="narrow-llama3-8b", vocab_size=384, d_model=64,
    n_layers=2, n_heads=8, n_kv_heads=2, d_ff=96, dtype=jnp.float32)
PAIR_DRAFT = narrowed("llama3.2-1b")


#: new tokens a row of the pair's decodes
PAIR_NEW = 10


def pair_prompts(seed):
    """Three right-padded prompts of 8-33 byte tokens in a [3, 64] grid, and
    their lengths."""
    rng = np.random.default_rng(seed)
    tokens = np.full((3, 64), 256, np.int32)
    plen = rng.integers(8, 34, size=3).astype(np.int32)
    for i, n in enumerate(plen):
        tokens[i, :n] = rng.integers(0, 250, size=n)
    return tokens, plen


def test_pair_keeps_the_reference_s_differences():
    assert (PAIR_TARGET.d_head, PAIR_DRAFT.d_head) == (128, 64)
    assert PAIR_TARGET.n_heads // PAIR_TARGET.n_kv_heads == 4
    assert PAIR_DRAFT.n_heads // PAIR_DRAFT.n_kv_heads == 4
    assert PAIR_TARGET.rope_scaling is None and PAIR_DRAFT.rope_scaling[1] == 32.0
    assert not PAIR_TARGET.tie_embeddings and PAIR_DRAFT.tie_embeddings
    assert PAIR_TARGET.vocab_size == PAIR_DRAFT.vocab_size


@pytest.mark.parametrize("gamma", [2, 4])
def test_narrowed_pair_gives_reference_greedy_tokens(gamma):
    """The port's speculative decode (draft and target through the kernel
    wrappers' CPU paths) gives tst's greedy_decode tokens, and the port's
    own greedy tokens, in every row."""
    target, draft = _params(PAIR_TARGET, seed=0), _params(PAIR_DRAFT, seed=5)
    tokens, plen = pair_prompts(gamma)
    max_new = PAIR_NEW
    want = np.asarray(jdecode.greedy_decode(jax.tree.map(jnp.asarray, target),
                                            jnp.asarray(tokens), jnp.asarray(plen), max_new,
                                            PAIR_TARGET))
    tt = bridge.to_torch(target)
    got, stats = tspec.speculative_greedy_decode(
        bridge.to_torch(draft), _port(PAIR_DRAFT), tt, _port(PAIR_TARGET),
        torch.from_numpy(tokens), torch.from_numpy(plen), max_new, gamma=gamma,
        use_pallas=True, return_stats=True)
    greedy = tdecode.greedy_decode(tt, torch.from_numpy(tokens), torch.from_numpy(plen),
                                   max_new, _port(PAIR_TARGET), use_pallas=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(greedy.numpy(), want)
    assert 1 <= stats["rounds"] <= max_new - 1 and int(stats["committed"].min()) >= max_new


def agreeing_pair(eps):
    """PAIR_TARGET's and PAIR_DRAFT's weights made to agree: neither
    model's attention reaches its residual stream (wo zero), the target
    takes the draft's embedding, MLP, final norm and (as its untied head)
    the draft's tied head, so both map the last token to the same next
    token. ``eps`` > 0 gives the target back its own wo scaled by eps: its
    next token then depends on its cache, and the draft's guess is right at
    some positions only."""
    target, draft = _params(PAIR_TARGET, seed=0), _params(PAIR_DRAFT, seed=5)
    for key in ("mlp_norm", "w_gate", "w_up", "w_down"):
        target["layers"][key] = draft["layers"][key].copy()
    draft["layers"]["wo"] = np.zeros_like(draft["layers"]["wo"])
    target["layers"]["wo"] = (eps * target["layers"]["wo"]).astype(np.float32)
    target["embed"], target["final_norm"] = draft["embed"].copy(), draft["final_norm"].copy()
    target["lm_head"] = np.ascontiguousarray(draft["embed"].T)
    return target, draft


@pytest.mark.parametrize("eps", [0.0, 0.05], ids=["full", "partial"])
@pytest.mark.parametrize("gamma", [2, 4])
def test_agreeing_pair_accepts_and_gives_reference_greedy_tokens(gamma, eps):
    """The accept path: with a draft that agrees by construction every round
    commits gamma draft tokens and the bonus, ceil((max_new - 1) / (gamma +
    1)) rounds after the prefill's token; with one that agrees in part the
    rounds fall between that and one a token. Both give tst's greedy_decode
    tokens in every row."""
    target, draft = agreeing_pair(eps)
    tokens, plen = pair_prompts(gamma)
    b, max_new = len(plen), PAIR_NEW
    want = np.asarray(jdecode.greedy_decode(jax.tree.map(jnp.asarray, target),
                                            jnp.asarray(tokens), jnp.asarray(plen), max_new,
                                            PAIR_TARGET))
    got, stats = tspec.speculative_greedy_decode(
        bridge.to_torch(draft), _port(PAIR_DRAFT), bridge.to_torch(target), _port(PAIR_TARGET),
        torch.from_numpy(tokens), torch.from_numpy(plen), max_new, gamma=gamma,
        use_pallas=True, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    full = -(-(max_new - 1) // (gamma + 1))
    if eps == 0.0:
        assert stats["rounds"] == full
        assert stats["committed"].tolist() == [1 + full * (gamma + 1)] * b
    else:
        assert full < stats["rounds"] < max_new - 1
