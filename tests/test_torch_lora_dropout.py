"""LoRA dropout in the port (tst_torch.models.lora) against tst's.

Torch cannot reproduce ``jax.random``'s stream, so the parity cases draw the
reference's masks with ``jax.random`` by its own key derivation (root
0x10A0, fold, optimizer count, the layer's split, the projection id) and
inject them through ``FoldTrainer(dropout_masks=...)``. With them, one
step's per-fold losses and LoRA gradients, and two fitted steps, match
tst's at 1e-5 (f32, the CPU). The port's own masks are deterministic in
(fold, step, layer, projection), differ when any of them changes, and keep
within binomial bounds of ``1 - dropout``. Remat with dropout is bit-equal
to no remat, in every mode. At dropout 0 a dropout key is ignored.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch.models import decoder as tdec
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec
from tst_torch.train import sft as tsft

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
PORT_TINY = ModelSpec(**{**dataclasses.asdict(TINY), "dtype": torch.float32})
DROPOUT = 0.25
TARGETS = ("q_proj", "v_proj", "o_proj", "up_proj", "down_proj")
JLSPEC = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32, dropout=DROPOUT, targets=TARGETS)
TLSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32, dropout=DROPOUT,
                        targets=TARGETS)
K = 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    """(params, tokens, loss_mask, answer_pos, t_max) as numpy: 12 rows of 128."""
    tb = tokenize_dataset(load_benchmark("synthetic:0.5", n=12, seed=0), ByteTokenizer(),
                          max_len=128)
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(0), TINY))
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    return params, tb.tokens, tb.loss_mask, tb.answer_pos, t_max


def _adapters(seed=2):
    rng = np.random.default_rng(seed)
    loras = [jax.tree.map(np.asarray, jlora.init_lora(key, TINY, JLSPEC))
             for key in jax.random.split(jax.random.key(seed), K)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *loras)
    for ab in stacked.values():
        ab["b"] = (0.1 * rng.normal(size=ab["b"].shape)).astype(np.float32)
    return stacked


def reference_masks(fold, step, layer, proj, shape, keep, device):
    """The mask tst draws for (fold, optimizer count, layer, projection):
    tst/train/sft.py:340 (the step key), tst/models/decoder.py:516 (a split
    a layer) and :444 (the projection's fold_in)."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(0x10A0), fold), step)
    layer_key = jax.random.split(key, TINY.n_layers)[layer]
    rng = jax.random.fold_in(layer_key, jdec._PROJ_IDS[proj])
    return torch.from_numpy(np.array(jax.random.bernoulli(rng, keep, shape))).to(device)


def _reference_step(params, lora, tokens, mask, pos, t_max, count):
    """tst's per-fold (loss, LoRA gradients) of one step, as its trainer's
    one_fold computes them."""
    losses, grads = [], []
    for f in range(K):
        rng = jax.random.fold_in(jax.random.fold_in(jax.random.key(0x10A0), f), count)
        rows = slice(f * 3, f * 3 + 3)
        loss, g = jax.value_and_grad(jsft.sft_loss_window, argnums=1)(
            params, jax.tree.map(lambda x, _f=f: jnp.asarray(x[_f]), lora),
            jnp.asarray(tokens[rows]), jnp.asarray(mask[rows]), jnp.asarray(pos[rows]), t_max,
            TINY, JLSPEC, False, False, None, False, rng)
        losses.append(float(loss))
        grads.append(jax.tree.map(np.asarray, g))
    return np.asarray(losses), jax.tree.map(lambda *xs: np.stack(xs), *grads)


@pytest.mark.parametrize("count", [0, 3])
def test_step_with_reference_masks_matches_reference(data, count):
    params, tokens, mask, pos, t_max = data
    lora = _adapters()
    want_loss, want_grads = _reference_step(params, lora, tokens, mask, pos, t_max, count)
    trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, K, t_max=t_max, use_pallas=True,
                               dropout_masks=reference_masks)
    shape = (K, 3, tokens.shape[1])
    losses, grads = trainer.loss_and_grads(
        bridge.to_torch(params), bridge.to_torch(lora),
        torch.from_numpy(tokens[:6]).reshape(shape), torch.from_numpy(mask[:6]).reshape(shape),
        torch.from_numpy(pos[:6]).reshape(K, 3), step=count)
    np.testing.assert_allclose(losses.numpy(), want_loss, atol=1e-5)
    for g, w in zip(tsft.tree_leaves(grads), tsft.tree_leaves(bridge.to_torch(want_grads))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)
    # dropout moved the numbers: without a step nothing is dropped
    plain, _ = trainer.loss_and_grads(
        bridge.to_torch(params), bridge.to_torch(lora),
        torch.from_numpy(tokens[:6]).reshape(shape), torch.from_numpy(mask[:6]).reshape(shape),
        torch.from_numpy(pos[:6]).reshape(K, 3))
    assert not torch.equal(plain, losses)


def test_fit_with_reference_masks_matches_reference(data):
    """Two FoldTrainer.fit steps with dropout: tst's (its own masks) against
    the port's with the reference's masks injected, atol 1e-5."""
    params, tokens, mask, pos, t_max = data
    fold_id = np.arange(tokens.shape[0], dtype=np.int32) % K
    batches = tsft.make_fold_batches(fold_id, K, 3, 2, seed=0)[:2]
    lora = _adapters(seed=4)
    kw = dict(lr=1e-2, total_steps=2, t_max=t_max)
    jtrainer = jsft.FoldTrainer(TINY, JLSPEC, K, **kw)
    jlora_k = jax.tree.map(jnp.asarray, lora)
    jout, _, jlog = jtrainer.fit(params, jlora_k, jax.vmap(jtrainer.tx.init)(jlora_k),
                                 jnp.asarray(tokens), jnp.asarray(mask), batches,
                                 all_pos=jnp.asarray(pos), log_every=1)
    ttrainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, K, dropout_masks=reference_masks, **kw)
    tlora_k = bridge.to_torch(lora)
    tout, _, tlog = ttrainer.fit(bridge.to_torch(params), tlora_k, ttrainer.tx.init(tlora_k),
                                 torch.from_numpy(tokens), torch.from_numpy(mask), batches,
                                 all_pos=torch.from_numpy(pos), log_every=1)
    np.testing.assert_allclose(tlog.fold_losses, jlog.fold_losses, atol=1e-5)
    for g, w in zip(tsft.tree_leaves(tout), tsft.tree_leaves(bridge.to_torch(
            jax.tree.map(np.asarray, jout)))):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)


def test_own_masks_deterministic_and_distinct():
    shape, keep = (4, 64, 96), 1 - DROPOUT
    base = tlora.dropout_mask(0, 5, 1, "q", shape, keep, "cpu")
    assert base.dtype == torch.bool and tuple(base.shape) == shape
    assert torch.equal(base, tlora.dropout_mask(0, 5, 1, "q", shape, keep, "cpu"))
    for other in ((1, 5, 1, "q"), (0, 6, 1, "q"), (0, 5, 2, "q"), (0, 5, 1, "v")):
        assert not torch.equal(base, tlora.dropout_mask(*other, shape, keep, "cpu")), other
    # keep rate within 5 binomial standard deviations
    n = base.numel()
    assert abs(base.float().mean().item() - keep) < 5 * math.sqrt(keep * (1 - keep) / n)
    # a DropoutKey draws fold by fold: row block f is fold f's own mask
    key = tlora.DropoutKey((0, 1), 5).at(1, "q")
    both = key.mask((8, 64, 96), keep, "cpu")
    assert torch.equal(both[:4], base)
    assert torch.equal(both[4:], tlora.dropout_mask(1, 5, 1, "q", shape, keep, "cpu"))


def test_delta_drops_the_adapter_input_only():
    """Inverted dropout on x in x's dtype: where(mask, x / keep, 0); no key,
    or dropout 0, leaves the delta as it was."""
    layer = {"a": torch.randn(4, 8, generator=torch.Generator().manual_seed(0)),
             "b": torch.randn(8, 4, generator=torch.Generator().manual_seed(1))}
    x = torch.randn(2, 16, 8, generator=torch.Generator().manual_seed(2))
    key = tlora.DropoutKey((0, 1), 3).at(0, "up")
    got = tlora.apply_lora_delta(layer, x, TLSPEC, rng=key)
    m = key.mask(x.shape, 1 - DROPOUT, "cpu")
    kept = torch.where(m, x / torch.tensor(1 - DROPOUT), torch.zeros(()))
    assert torch.equal(got, tlora.apply_lora_delta(layer, kept, TLSPEC))
    no_drop = dataclasses.replace(TLSPEC, dropout=0.0)
    assert torch.equal(tlora.apply_lora_delta(layer, x, TLSPEC),
                       tlora.apply_lora_delta(layer, x, no_drop, rng=key))


def test_lora_rng_ignored_at_dropout_zero(data):
    """As the reference: at dropout 0 a dropout key changes nothing."""
    params, tokens, *_ = data
    spec0 = dataclasses.replace(TLSPEC, dropout=0.0)
    lora = bridge.to_torch(_adapters())
    args = (bridge.to_torch(params), torch.from_numpy(tokens[:4]), PORT_TINY)
    want = tdec.apply_model(*args, lora=lora, lora_spec=spec0)
    got = tdec.apply_model(*args, lora=lora, lora_spec=spec0,
                           lora_rng=tlora.DropoutKey((0, 1), 7))
    assert torch.equal(got, want)


@pytest.mark.parametrize("remat", [True, "full", "dots", "dots_attn", "dots_flash", "light",
                                   "attn", "flash"])
def test_remat_with_dropout_bitwise(data, remat):
    """The recomputing backward redraws each mask from its (fold, step,
    layer, projection) seed: losses and gradients bit-equal to no remat."""
    params, tokens, mask, pos, t_max = data
    lora = bridge.to_torch(_adapters())
    shape = (K, 3, tokens.shape[1])
    batch = (torch.from_numpy(tokens[:6]).reshape(shape),
             torch.from_numpy(mask[:6]).reshape(shape), torch.from_numpy(pos[:6]).reshape(K, 3))
    out = {}
    for mode in (False, remat):
        trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, K, t_max=t_max, use_pallas=True,
                                   remat=mode)
        out[mode] = trainer.loss_and_grads(bridge.to_torch(params), lora, *batch, step=4)
    assert torch.equal(out[remat][0], out[False][0])
    for g, w in zip(tsft.tree_leaves(out[remat][1]), tsft.tree_leaves(out[False][1])):
        assert torch.equal(g, w)
