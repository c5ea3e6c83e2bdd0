"""The port's packed path against tst on the same inputs: the decoder with
``seg_starts``, the packed answer-window loss, a packed FoldTrainer step and
fit, and the packed held-out scorer.

Weights are the JAX ``init_params``, adapters JAX ``init_lora`` draws with B
drawn nonzero, carried across by tst_torch.bridge; packed rows come from the
reference packer (the port's is bit-equal to it, tests/test_torch_packing.py)
on the synthetic MCQ benchmark. f32 on the CPU. Tolerances as in
tests/test_torch_decoder.py and tests/test_torch_sft.py: 1e-4 for whole
models and after optimizer steps, 1e-5 for one loss, one step's gradients
and letter probabilities (f32 sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.data import packing as jpack
from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import infer as jinfer
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch.kernels.flash_attention import SEG_PAD
from tst_torch.models import decoder as tdec
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec
from tst_torch.train import infer as tinfer
from tst_torch.train import sft as tsft

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
#: narrow Qwen2.5-shaped spec: QKV biases, tied head, GQA 7:1, theta 1e6
QWEN = jdec.ModelSpec("narrow-qwen", vocab_size=384, d_model=56, n_layers=2, n_heads=7,
                      n_kv_heads=1, d_head=8, d_ff=96, rope_theta=1000000.0,
                      qkv_bias=True, tie_embeddings=True, dtype=jnp.float32)
JLSPEC = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
TLSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
#: starts inside 64-row tiles, all SEG_PAD, one segment, a first start after 0
STARTS = np.array([[0, 1, 63, 64, 65, 100] + [SEG_PAD] * 2, [SEG_PAD] * 8,
                   [0] + [SEG_PAD] * 7, [7, 70] + [SEG_PAD] * 6], np.int32)


def _port(spec):
    return ModelSpec(**{**dataclasses.asdict(spec), "dtype": torch.float32})


def _params(spec, seed=0):
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(seed), spec))
    rng = np.random.default_rng(seed)
    for key in ("bq", "bk", "bv"):
        if key in params["layers"]:  # non-trivial biases
            shape = params["layers"][key].shape
            params["layers"][key] = (0.2 * rng.normal(size=shape)).astype(np.float32)
    return params


def _adapters(k, seed=0):
    """k JAX init_lora draws stacked on a fold axis, B drawn nonzero."""
    rng = np.random.default_rng(seed)
    loras = [jax.tree.map(np.asarray, jlora.init_lora(key, TINY, JLSPEC))
             for key in jax.random.split(jax.random.key(seed), k)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *loras)
    for ab in stacked.values():
        ab["b"] = (0.1 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    return stacked


def _close(got, want, atol):
    for g, w in zip(tsft.tree_leaves(got), tsft.tree_leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=atol)


@pytest.mark.parametrize("name", ["tiny", "qwen"])
def test_apply_model_with_segments_matches_reference(name):
    """Logits and hidden states of packed rows (segment mask, per-segment
    RoPE positions) against tst's apply_model(seg_starts=), f32, dense path
    and the kernel wrapper's CPU path."""
    spec = {"tiny": TINY, "qwen": QWEN}[name]
    params = _params(spec)
    tokens = np.random.default_rng(3).integers(0, spec.vocab_size, (4, 128)).astype(np.int32)
    args = (jnp.asarray(tokens), spec)
    want = np.asarray(jdec.apply_model(params, *args, seg_starts=jnp.asarray(STARTS)))
    want_h = np.asarray(jdec.apply_model(params, *args, seg_starts=jnp.asarray(STARTS),
                                         return_hidden=True))
    tp, tt, ts = bridge.to_torch(params), torch.from_numpy(tokens), _port(spec)
    seg = torch.from_numpy(STARTS)
    for use_pallas in (False, True):
        got = tdec.apply_model(tp, tt, ts, use_pallas=use_pallas, seg_starts=seg)
        got_h = tdec.apply_model(tp, tt, ts, use_pallas=use_pallas, seg_starts=seg,
                                 return_hidden=True)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got_h.numpy(), want_h, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_packed_row_equals_samples_unpacked(use_pallas):
    """The reference's packing invariant, on the port alone: the hidden
    states of a packed row at each segment equal the same samples run
    unpacked (atol 1e-5)."""
    spec = _port(QWEN)
    tp = bridge.to_torch(_params(QWEN, seed=1))
    rng = np.random.default_rng(4)
    lengths = [40, 57, 23]
    samples = [torch.from_numpy(rng.integers(0, 384, (1, n)).astype(np.int32)) for n in lengths]
    row = torch.cat(samples + [torch.zeros(1, 128 - sum(lengths), dtype=torch.int32)], 1)
    seg = torch.tensor([[0, 40, 97] + [SEG_PAD] * 5], dtype=torch.int32)
    packed = tdec.apply_model(tp, row, spec, use_pallas=use_pallas, seg_starts=seg,
                              return_hidden=True)
    off = 0
    for sample, n in zip(samples, lengths):
        alone = tdec.apply_model(tp, sample, spec, use_pallas=use_pallas, return_hidden=True)
        np.testing.assert_allclose(packed[:, off:off + n].numpy(), alone.numpy(), atol=1e-5)
        off += n


@pytest.fixture(scope="module")
def packed():
    """(params, tb, fold_id, FoldPacked, t_max): 16 samples, 2 folds, rows of
    1024 (three samples a row)."""
    ds = load_benchmark("synthetic:0.5", n=16, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer())
    fold_id = (np.arange(tb.n) % 2).astype(np.int32)
    fp = jpack.pack_fold_datasets(tb, fold_id, 2, 2 * tb.seq_len)
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(0), TINY))
    return params, tb, fold_id, fp, int(np.max(tb.lengths - tb.answer_pos - 1))


def test_packed_losses_match_reference(packed):
    """The packed window loss (one window per segment, clipped at the next
    segment's start) and the full-sequence loss with seg_starts, against
    tst's, one adapter, f32, atol 1e-5. A window of 400 tokens runs past
    each segment's end; clipped, it gives the loss of the real window."""
    params, _, _, fp, t_max = packed
    lora = jax.tree.map(lambda x: x[0], _adapters(1))
    rows = np.arange(fp.n_rows[0])
    data = [fp.tokens[0, rows], fp.loss_mask[0, rows], fp.answer_pos[0, rows],
            fp.seg_starts[0, rows]]
    jt, jm, jp, js = map(jnp.asarray, data)
    tt, tm, tpos, ts = map(torch.from_numpy, data)
    tp, tl = bridge.to_torch(params), bridge.to_torch(lora)
    want = float(jsft.sft_loss(params, lora, jt, jm, TINY, JLSPEC, seg_starts=js))
    got = tsft.sft_loss(tp, tl, tt, tm, _port(TINY), TLSPEC, seg_starts=ts)
    np.testing.assert_allclose(got.item(), want, atol=1e-5)
    windows = {}
    for t in (t_max, 400):
        want = float(jsft.sft_loss_window(params, lora, jt, jm, jp, t, TINY, JLSPEC,
                                          seg_starts=js))
        for use_pallas in (False, True):
            got = tsft.sft_loss_window(tp, tl, tt, tm, tpos, t, _port(TINY), TLSPEC,
                                       use_pallas=use_pallas, seg_starts=ts)
            np.testing.assert_allclose(got.item(), want, atol=1e-5)
        windows[t] = got.item()
    np.testing.assert_allclose(windows[400], windows[t_max], atol=1e-5)


@pytest.mark.parametrize("windowed", [True, False])
def test_packed_fold_step_loss_and_grads_match_reference(packed, windowed):
    """One packed fold-parallel step, 2 folds x 2 packed rows, each fold
    from its own split: per-fold losses and the fold-stacked LoRA gradients
    against jax.value_and_grad of tst's loss per fold (atol 1e-5)."""
    params, _, _, fp, t_max = packed
    k, idx = 2, np.array([[0, 2], [1, 0]])
    lora = _adapters(k, seed=1)
    t_max = t_max if windowed else None
    want_losses, want_grads = [], []
    for f in range(k):
        tok, mask, pos, seg = (jnp.asarray(a[f, idx[f]]) for a in (
            fp.tokens, fp.loss_mask, fp.answer_pos, fp.seg_starts))
        fold_lora = jax.tree.map(lambda x: x[f], lora)
        if windowed:
            loss, grads = jax.value_and_grad(jsft.sft_loss_window, argnums=1)(
                params, fold_lora, tok, mask, pos, t_max, TINY, JLSPEC, seg_starts=seg)
        else:
            loss, grads = jax.value_and_grad(jsft.sft_loss, argnums=1)(
                params, fold_lora, tok, mask, TINY, JLSPEC, seg_starts=seg)
        want_losses.append(float(loss))
        want_grads.append(grads)
    trainer = tsft.FoldTrainer(_port(TINY), TLSPEC, k, use_pallas=True, t_max=t_max, packed=True)
    gathered = [torch.from_numpy(np.stack([a[f, idx[f]] for f in range(k)]))
                for a in (fp.tokens, fp.loss_mask, fp.answer_pos, fp.seg_starts)]
    losses, grads = trainer.loss_and_grads(bridge.to_torch(params), bridge.to_torch(lora),
                                           *gathered)
    np.testing.assert_allclose(losses.numpy(), want_losses, atol=1e-5)
    _close(grads, jax.tree.map(lambda *xs: np.stack(xs), *want_grads), atol=1e-5)


def test_packed_fit_matches_reference(packed):
    """Two packed FoldTrainer.fit steps from bridged adapters against tst's
    packed FoldTrainer: logged losses and the adapters after the steps (atol
    1e-4); samples/s counts the packed samples, not the rows."""
    params, _, _, fp, t_max = packed
    k = 2
    batches = jpack.make_packed_fold_batches(fp.n_rows, 2, 1, seed=0)[:2]
    lora = _adapters(k, seed=2)
    kw = dict(lr=1e-2, total_steps=2, warmup_frac=0.03, weight_decay=0.01, t_max=t_max,
              packed=True)
    jtrainer = jsft.FoldTrainer(TINY, JLSPEC, k, **kw)
    jlora_k = jax.tree.map(jnp.asarray, lora)
    jout, _, jlog = jtrainer.fit(
        params, jlora_k, jax.vmap(jtrainer.tx.init)(jlora_k), jnp.asarray(fp.tokens),
        jnp.asarray(fp.loss_mask), batches, all_pos=jnp.asarray(fp.answer_pos),
        all_segs=jnp.asarray(fp.seg_starts), n_segs=fp.n_segs, log_every=1)
    ttrainer = tsft.FoldTrainer(_port(TINY), TLSPEC, k, use_pallas=True, **kw)
    tlora_k = bridge.to_torch(lora)
    arrays = [torch.from_numpy(a) for a in (fp.tokens, fp.loss_mask, fp.answer_pos,
                                            fp.seg_starts)]
    tout, state, tlog = ttrainer.fit(bridge.to_torch(params), tlora_k, ttrainer.tx.init(tlora_k),
                                     arrays[0], arrays[1], batches, all_pos=arrays[2],
                                     all_segs=arrays[3], n_segs=fp.n_segs, log_every=1)
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=1e-4)
    np.testing.assert_allclose(tlog.fold_losses, jlog.fold_losses, atol=1e-4)
    _close(tout, jout, atol=1e-4)
    n_samples = int(sum(fp.n_segs[f, batches[:, f]].sum() for f in range(k)))
    assert n_samples > batches.size and state.count == 2
    assert tlog.samples_per_sec == pytest.approx(n_samples / tlog.wall_seconds)
    with pytest.raises(ValueError, match="needs all_segs"):
        ttrainer.fit(bridge.to_torch(params), tlora_k, state, arrays[0], arrays[1], batches,
                     all_pos=arrays[2])
    with pytest.raises(ValueError, match="packed=True"):
        tsft.FoldTrainer(_port(TINY), TLSPEC, k, t_max=t_max).fit(
            bridge.to_torch(params), tlora_k, state, arrays[0], arrays[1], batches,
            all_pos=arrays[2], all_segs=arrays[3])


def test_packed_scorer_matches_reference(packed):
    """Held-out letter probabilities of the packed scorer against tst's
    score_heldout_mcq_packed with fold-stacked adapters and without (f32,
    atol 1e-5; chunks of 4 packed rows), and against the port's own unpacked scorer: packing does
    not change a sample's probabilities."""
    params, tb, fold_id, _, _ = packed
    lora = _adapters(2, seed=3)
    tp = bridge.to_torch(params)
    for lora_k in (lora, None):
        jl = None if lora_k is None else jax.tree.map(jnp.asarray, lora_k)
        want = jinfer.score_heldout_mcq_packed(params, jl, TINY, JLSPEC, tb, fold_id, 2,
                                               pack_len=1024, batch=4)
        tl = None if lora_k is None else bridge.to_torch(lora_k)
        for use_pallas in (False, True):
            got = tinfer.score_heldout_mcq_packed(tp, tl, _port(TINY), TLSPEC, tb, fold_id, 2,
                                                  pack_len=1024, use_pallas=use_pallas, batch=4)
            assert got.shape == want.shape == (tb.n, 4)
            np.testing.assert_allclose(got, want, atol=1e-5)
        unpacked = tinfer.score_heldout_mcq(
            tp, tl, _port(TINY), TLSPEC, torch.from_numpy(tb.tokens),
            torch.from_numpy(tb.answer_pos), tb.option_token_ids, tb.n_options, fold_id, 2)
        np.testing.assert_allclose(got, unpacked, atol=1e-5)
