"""The port's fold-parallel SFT against tst.train.sft on the same inputs.

Weights are the JAX ``init_params``; adapters are JAX ``init_lora`` draws
with B drawn nonzero (a zero B leaves every A-gradient 0), carried across
by tst_torch.bridge; data is the synthetic MCQ benchmark through the shared
tokenizer. f32 on the CPU. Tolerances: 1e-5 for one loss or one step's
gradients, 1e-4 after three optimizer steps (f32 sums in another order,
compounded), 1e-6 relative for the schedule and optimizer arithmetic.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch.models import lora as tlora
from tst_torch.models.spec import ModelSpec
from tst_torch.train import sft as tsft

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
JLSPEC = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
TLSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
PORT_TINY = ModelSpec(**{**dataclasses.asdict(TINY), "dtype": torch.float32})


@pytest.fixture(scope="module")
def data():
    """(params, tokens, loss_mask, answer_pos, t_max) as numpy, 12 rows."""
    tb = tokenize_dataset(load_benchmark("synthetic:0.5", n=12, seed=0), ByteTokenizer())
    params = jax.tree.map(np.asarray, jdec.init_params(jax.random.key(0), TINY))
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    return params, tb.tokens, tb.loss_mask, tb.answer_pos, t_max


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
    """Tree of tensors against a tree of JAX/numpy arrays."""
    for g, w in zip(tsft.tree_leaves(got), tsft.tree_leaves(jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=atol)


def test_sft_losses_match_reference(data):
    params, tokens, mask, pos, t_max = data
    lora = jax.tree.map(lambda x: x[0], _adapters(1))
    rows = slice(0, 4)
    jargs = (params, lora, jnp.asarray(tokens[rows]), jnp.asarray(mask[rows]))
    targs = (bridge.to_torch(params), bridge.to_torch(lora), torch.from_numpy(tokens[rows]),
             torch.from_numpy(mask[rows]))
    want = jsft.sft_loss(*jargs, TINY, JLSPEC)
    got = tsft.sft_loss(*targs, PORT_TINY, TLSPEC)
    assert got.ndim == 0
    np.testing.assert_allclose(got.item(), float(want), atol=1e-5)
    want = jsft.sft_loss_window(*jargs, jnp.asarray(pos[rows]), t_max, TINY, JLSPEC)
    for use_pallas in (False, True):
        got = tsft.sft_loss_window(*targs, torch.from_numpy(pos[rows]), t_max, PORT_TINY, TLSPEC,
                                   use_pallas=use_pallas)
        np.testing.assert_allclose(got.item(), float(want), atol=1e-5)


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_fold_step_loss_and_grads_match_reference(data, windowed, use_pallas):
    """One fold-parallel step, 2 folds x 3 rows: the per-fold losses and the
    fold-stacked LoRA gradients against jax.value_and_grad of tst's loss run
    per fold with that fold's adapter (atol 1e-5)."""
    params, tokens, mask, pos, t_max = data
    k, b = 2, 3
    lora = _adapters(k, seed=1)
    t_max = t_max if windowed else None
    loss_fn = jsft.sft_loss_window if windowed else jsft.sft_loss
    want_losses, want_grads = [], []
    for f in range(k):
        rows = slice(f * b, (f + 1) * b)
        args = [params, jax.tree.map(lambda x: x[f], lora), jnp.asarray(tokens[rows]),
                jnp.asarray(mask[rows])]
        if windowed:
            args += [jnp.asarray(pos[rows]), t_max]
        loss, grads = jax.value_and_grad(loss_fn, argnums=1)(*args, TINY, JLSPEC)
        want_losses.append(float(loss))
        want_grads.append(grads)
    trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, k, use_pallas=use_pallas, t_max=t_max)
    shape = (k, b, tokens.shape[1])
    losses, grads = trainer.loss_and_grads(
        bridge.to_torch(params), bridge.to_torch(lora),
        torch.from_numpy(tokens[:k * b]).reshape(shape),
        torch.from_numpy(mask[:k * b]).reshape(shape),
        torch.from_numpy(pos[:k * b]).reshape(k, b))
    np.testing.assert_allclose(losses.numpy(), want_losses, atol=1e-5)
    _close(grads, jax.tree.map(lambda *xs: np.stack(xs), *want_grads), atol=1e-5)


@pytest.mark.parametrize("total,frac", [(51, 0.03), (7, 0.03), (100, 0.1), (1, 0.03),
                                        (40, 0.5)])
def test_schedule_matches_optax(total, frac):
    """Every step's lr against optax's warmup_cosine_decay_schedule with the
    reference's arguments (sft.py:146-150): 0 at the first update."""
    lr = 3e-4
    warmup = max(int(total * frac), 1)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1), end_value=lr * 0.05)
    got = tsft.warmup_cosine_schedule(lr, total, frac)
    assert got(0) == 0.0
    for count in range(total + 3):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adamw_matches_optax(weight_decay):
    """Three updates on the same gradients against tst's make_optimizer
    (optax.adamw with the warmup-cosine schedule): updates and parameters
    at rtol 1e-6; the moments keep the parameters' dtype."""
    rng = np.random.default_rng(0)
    params = {"q": {"a": rng.normal(size=(2, 3, 4, 8)).astype(np.float32),
                    "b": rng.normal(size=(2, 3, 8, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), params)
             for _ in range(3)]
    jtx = jsft.make_optimizer(1e-2, 6, warmup_frac=0.34, weight_decay=weight_decay)
    ttx = tsft.make_optimizer(1e-2, 6, warmup_frac=0.34, weight_decay=weight_decay)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jtx.init(jp)
    tp = bridge.to_torch(params)
    tstate = ttx.init(tp)
    for g in grads:
        jup, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, jup)
        tup, tstate = ttx.update(bridge.to_torch(g), tstate, tp)
        tp = tsft.apply_updates(tp, tup)
        for got, want in ((tup, jup), (tp, jp)):
            for gl, wl in zip(tsft.tree_leaves(got), tsft.tree_leaves(
                    jax.tree.map(np.asarray, want))):
                np.testing.assert_allclose(gl.numpy(), wl, rtol=1e-6, atol=1e-9)
    assert tstate.count == 3 and tstate.mu["q"]["a"].dtype == torch.float32


@pytest.mark.parametrize("k,batch,epochs,seed,multiple,masked", [
    (2, 16, 3, 0, 1, False), (5, 4, 2, 3, 1, False), (3, 5, 1, 1, 4, False),
    (4, 8, 2, 2, 1, True)])
def test_make_fold_batches_bit_equal(k, batch, epochs, seed, multiple, masked):
    fold_id = np.random.default_rng(seed).integers(0, k, 97).astype(np.int32)
    mask = np.random.default_rng(seed + 1).random(97) > 0.3 if masked else None
    want = jsft.make_fold_batches(fold_id, k, batch, epochs, seed, batch_multiple=multiple,
                                  include_mask=mask)
    got = tsft.make_fold_batches(fold_id, k, batch, epochs, seed, batch_multiple=multiple,
                                 include_mask=mask)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="empty train split"):
        tsft.make_fold_batches(np.zeros(4, np.int32), 2, 2, 1, 0)


def test_fit_matches_reference(data):
    """Three FoldTrainer.fit steps from bridged JAX adapters against tst's
    FoldTrainer (its plain attention; the port through the Function's CPU
    path): logged losses and the adapters after the steps, atol 1e-4."""
    params, tokens, mask, pos, t_max = data
    k = 2
    fold_id = np.arange(tokens.shape[0], dtype=np.int32) % k
    batches = tsft.make_fold_batches(fold_id, k, 3, 2, seed=0)[:3]
    lora = _adapters(k, seed=2)
    kw = dict(lr=1e-2, total_steps=3, warmup_frac=0.03, weight_decay=0.01, t_max=t_max)
    jtrainer = jsft.FoldTrainer(TINY, JLSPEC, k, **kw)
    jlora_k = jax.tree.map(jnp.asarray, lora)
    jout, _, jlog = jtrainer.fit(params, jlora_k, jax.vmap(jtrainer.tx.init)(jlora_k),
                                 jnp.asarray(tokens), jnp.asarray(mask), batches,
                                 all_pos=jnp.asarray(pos), log_every=1)
    ttrainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, k, use_pallas=True, **kw)
    tlora_k = bridge.to_torch(lora)
    calls = []
    tout, state, tlog = ttrainer.fit(bridge.to_torch(params), tlora_k, ttrainer.tx.init(tlora_k),
                                     torch.from_numpy(tokens), torch.from_numpy(mask), batches,
                                     all_pos=torch.from_numpy(pos), log_every=1,
                                     log_fn=lambda step, loss: calls.append(step))
    np.testing.assert_allclose(tlog.losses, jlog.losses, atol=1e-4)
    np.testing.assert_allclose(tlog.fold_losses, jlog.fold_losses, atol=1e-4)
    _close(tout, jout, atol=1e-4)
    assert calls == [1, 2, 3] and tlog.steps == jlog.steps == 3 and state.count == 3
    assert tlog.wall_seconds >= tlog.first_step_seconds > 0
    assert tlog.samples_per_sec == pytest.approx(3 * k * 3 / tlog.wall_seconds)


def test_init_state_and_ckpt_extra():
    trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, 3)
    lora, state = trainer.init_state(torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda x: x.shape, jsft.FoldTrainer(TINY, JLSPEC, 3).init_state(
        jax.random.key(0))[0])
    assert jax.tree.map(lambda t: tuple(t.shape), lora) == want
    a = lora["q"]["a"]
    assert not torch.equal(a[0], a[1]) and not lora["q"]["b"].any()  # folds decorrelated
    assert state.count == 0 and not state.mu["q"]["a"].any()
    assert trainer.ckpt_extra(step=4) == jsft.FoldTrainer(TINY, JLSPEC, 3).ckpt_extra(step=4)


@pytest.mark.parametrize("kw,item", [
    ({"ring": True}, "item 16"), ({"mesh": "one rank"}, "item 16")])
def test_unported_trainer_options_raise(kw, item):
    """``ring`` and ``mesh`` raised until item 16 was ported. A ring without
    a mesh is no ring (the reference's ``ring_mesh``), and a mesh of one rank
    is the one-process trainer; k that the fold axis does not divide
    raises."""
    from tst_torch.runtime import mesh as tmesh

    if "mesh" in kw:
        kw = {"mesh": tmesh.make_mesh(), "ring": True}
    trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, 2, **kw)
    assert trainer.mesh is None and trainer.ring_mesh is None
    assert trainer.folds == range(2)
    two = tmesh.Mesh(np.arange(2).reshape(2, 1, 1, 1), 1, {})
    assert tsft.FoldTrainer(PORT_TINY, TLSPEC, 4, mesh=two).folds == range(2, 4)
    with pytest.raises(ValueError, match="k=3 folds do not split"):
        tsft.FoldTrainer(PORT_TINY, TLSPEC, 3, mesh=two)


@pytest.mark.parametrize("windowed", [True, False])
def test_fused_mlp_trainer_matches_reference(data, windowed, monkeypatch):
    """``fused_mlp`` through the trainer, 2 folds x 2 rows: per-fold losses
    and LoRA gradients against jax.value_and_grad of tst's loss with
    ``use_pallas`` and ``fused_mlp`` (its Pallas kernels in interpret mode,
    the fused MLP's custom_vjp backward), atol 1e-5. The port's fused MLP
    (its plain forward on CPU tensors) runs once a layer."""
    import tst.kernels.flash_attention as jfa
    import tst.kernels.fused_mlp as jfm
    import tst_torch.kernels.fused_mlp as tfm
    import tst_torch.models.decoder as tdec

    monkeypatch.setattr(jfa, "_INTERPRET", True)
    monkeypatch.setattr(jfm, "_INTERPRET", True)
    params, tokens, mask, pos, t_max = data
    k, b = 2, 2
    lora = _adapters(k, seed=4)
    t_max = t_max if windowed else None
    loss_fn = jsft.sft_loss_window if windowed else jsft.sft_loss
    want_losses, want_grads = [], []
    for f in range(k):
        rows = slice(f * b, (f + 1) * b)
        args = [params, jax.tree.map(lambda x: x[f], lora), jnp.asarray(tokens[rows]),
                jnp.asarray(mask[rows])]
        if windowed:
            args += [jnp.asarray(pos[rows]), t_max]
        loss, grads = jax.value_and_grad(loss_fn, argnums=1)(
            *args, TINY, JLSPEC, use_pallas=True, fused_mlp=True)
        want_losses.append(float(loss))
        want_grads.append(grads)
    calls = []
    monkeypatch.setattr(tdec, "fused_swiglu_mlp",
                        lambda *a, **kw: calls.append(1) or tfm.fused_swiglu_mlp(*a, **kw))
    trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, k, use_pallas=True, t_max=t_max,
                               fused_mlp=True)
    shape = (k, b, tokens.shape[1])
    before = tfm.LAUNCHES
    losses, grads = trainer.loss_and_grads(
        bridge.to_torch(params), bridge.to_torch(lora),
        torch.from_numpy(tokens[:k * b]).reshape(shape),
        torch.from_numpy(mask[:k * b]).reshape(shape),
        torch.from_numpy(pos[:k * b]).reshape(k, b))
    assert len(calls) == TINY.n_layers and tfm.LAUNCHES == before
    np.testing.assert_allclose(losses.numpy(), want_losses, atol=1e-5)
    _close(grads, jax.tree.map(lambda *xs: np.stack(xs), *want_grads), atol=1e-5)


def test_unported_fit_and_loss_options_raise(data):
    """The fit's own refusals (the mesh and ring options, which raised here
    until item 16 was ported, are tested in tests/test_torch_mesh.py)."""
    params, tokens, mask, pos, t_max = data
    trainer = tsft.FoldTrainer(PORT_TINY, TLSPEC, 2, t_max=t_max)
    lora, state = trainer.init_state(torch.Generator().manual_seed(0))
    args = (bridge.to_torch(params), lora, state, torch.from_numpy(tokens),
            torch.from_numpy(mask), np.zeros((1, 2, 2), np.int32))
    with pytest.raises(ValueError, match="needs all_pos"):
        trainer.fit(*args)
