"""Serving a trained adapter: tst trains and writes its Orbax checkpoint;
the test reads it with ``tst.aux.ckpt.load_train_state``, converts it with
``tst_torch.bridge.save_adapter_checkpoint`` into the port's format, and
serves it through both packages' ``run_blind_eval(adapter_dir=..., fold=...)``.

For ``--fold 0``, ``1`` and ``mean``, on the MCQ + numeric mix
(synthetic-vsi:0.4) and on open rows (synthetic-open): the letter
probabilities of the served adapter agree at atol 1e-5, and blind_eval.json
agrees (accuracy, numeric MRA and open accuracy equal, the adapter fields
set alike). ``mean`` averages in the adapter's dtype, bit-equal to tst's in
bf16 and f32. A model-name mismatch and an out-of-range fold raise as in
tst; a stamp without ``k`` falls back to the serving config as in tst.
Weights are the JAX ``init_params`` carried across by tst_torch.bridge; f32
on the CPU.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tst import config as config_mod
from tst.aux import ckpt as jckpt
from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer
from tst.train import infer as jinfer
from tst.train import pipeline as jpipe
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch import config as tconfig
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.models.spec import ModelSpec
from tst_torch.train import infer as tinfer
from tst_torch.train import pipeline as tpipe

CPU = torch.device("cpu")
BENCHES = ("synthetic-vsi:0.4", "synthetic-open")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(out_dir, bench="synthetic-vsi:0.4", *extra):
    return ["model.name=tiny", "model.dtype=float32", f"data.bench={bench}", "data.n=24",
            "data.max_len=128", "data.k=2", "optim.batch_size=4", "optim.epochs=1",
            "rf.cross_check=false", f"out_dir={out_dir}", *extra]


def _bridged_model(cfg, tokenizer, device, mesh=None):
    """The port's build_model giving the JAX package's weights."""
    spec, params = jpipe.build_model(config_mod.resolve(None, None, [
        f"model.name={cfg.model.name}", f"model.dtype={cfg.model.dtype}",
        f"data.seed={cfg.data.seed}"]), tokenizer)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.model.dtype]
    return (ModelSpec(**{**dataclasses.asdict(spec), "dtype": dtype}),
            bridge.to_torch(jax.tree.map(np.asarray, params), device))


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    """(tst's checkpoint dir, the port's conversion of it): tst's
    diagnose-sft with checkpoint_dir, k=2, one epoch."""
    root = tmp_path_factory.mktemp("serve")
    cfg = config_mod.resolve(None, None, _args(root / "train",
                                               "synthetic-vsi:0.4",
                                               f"checkpoint_dir={root / 'jck'}"))
    jpipe.run_sft_diagnostic(load_benchmark("synthetic-vsi:0.4", n=24, seed=0), cfg)
    jdir = str(root / "jck" / "seed_0_epoch_000")
    spec, _ = jpipe.build_model(cfg, ByteTokenizer())
    trainer = jsft.FoldTrainer(spec, jpipe.lora_spec_from_cfg(cfg, spec.dtype), 2)
    like_lora, like_opt = trainer.init_state(jax.random.key(0))
    lora, opt, extra = jckpt.load_train_state(jdir, like_lora, like_opt)
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    tdir = str(root / "tck")
    bridge.save_adapter_checkpoint(tdir, jax.tree.map(np.asarray, lora),
                                   jax.tree.map(np.asarray, adam.mu),
                                   jax.tree.map(np.asarray, adam.nu),
                                   int(np.asarray(adam.count).reshape(-1)[0]), extra)
    return jdir, tdir


@pytest.mark.parametrize("bench", BENCHES)
@pytest.mark.parametrize("fold", ["0", "1", "mean"])
def test_blind_eval_with_adapter_matches_reference(adapters, tmp_path, monkeypatch, bench,
                                                    fold):
    jdir, tdir = adapters
    monkeypatch.setattr(tpipe, "build_model", _bridged_model)
    jcfg = config_mod.resolve(None, None, _args(tmp_path / "j", bench))
    tcfg = tconfig.resolve(None, None, _args(tmp_path / "t", bench))
    want = jpipe.run_blind_eval(load_benchmark(bench, n=24, seed=0), jcfg, adapter_dir=jdir,
                                fold=fold)
    got = tpipe.run_blind_eval(tload_benchmark(bench, n=24, seed=0), tcfg, CPU,
                               adapter_dir=tdir, fold=fold)
    with open(tmp_path / "t" / "blind_eval.json") as f:
        assert json.load(f) == got
    assert got["zero_shot"] is False and got["adapter"] == tdir and got["adapter_fold"] == fold
    assert want["adapter"] == jdir and want["adapter_fold"] == fold
    keys = set(want) - {"wall_seconds", "adapter"}
    assert set(got) - {"wall_seconds", "adapter"} == keys
    for key in keys:
        assert got[key] == want[key], key
    assert ("numeric_blind_mra" in got) == (bench == "synthetic-vsi:0.4")
    assert ("open_blind_accuracy" in got) == (bench == "synthetic-open")

    # the served adapter's letter probabilities
    spec, jparams = jpipe.build_model(jcfg, ByteTokenizer())
    tspec, tparams = _bridged_model(tcfg, ByteTokenizer(), CPU)
    jone, jls = jpipe.load_adapter_lora(jdir, jcfg, spec, fold=fold)
    tone, tls = tpipe.load_adapter_lora(tdir, tcfg, tspec, fold=fold)
    tb, tokens, pos, _, _ = tpipe.prepare_blind_eval(tload_benchmark(bench, n=24, seed=0), tcfg,
                                                     CPU)
    if int(np.max(tb.n_options, initial=0)) > 0:
        zeros = np.zeros(tb.n, np.int32)
        pw = jinfer.score_heldout_mcq(jparams, jone, spec, jls, jnp.asarray(tb.tokens),
                                      jnp.asarray(tb.answer_pos), tb.option_token_ids,
                                      tb.n_options, zeros, 1)
        pg = tinfer.score_heldout_mcq(tparams, tone, tspec, tls, tokens, pos,
                                      tb.option_token_ids, tb.n_options, zeros, 1)
        np.testing.assert_allclose(pg, pw, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fold", ["1", "mean"])
def test_load_adapter_lora_bitwise(adapters, tmp_path, dtype, fold):
    """The served adapter, read into the serving dtype, bit-equal to tst's;
    without the fold axis for the decoders."""
    jdir, tdir = adapters
    args = _args(tmp_path, "synthetic:0.5", f"model.dtype={dtype}")
    jcfg, tcfg = config_mod.resolve(None, None, args), tconfig.resolve(None, None, args)
    spec, _ = jpipe.build_model(jcfg, ByteTokenizer())
    tspec = tpipe.model_spec(tcfg, ByteTokenizer())
    for keep in (True, False):
        want, wls = jpipe.load_adapter_lora(jdir, jcfg, spec, fold=fold, keep_fold_axis=keep)
        got, gls = tpipe.load_adapter_lora(tdir, tcfg, tspec, fold=fold, keep_fold_axis=keep)
        assert (gls.rank, gls.alpha, gls.targets) == (wls.rank, wls.alpha, wls.targets)
        assert gls.dtype == tspec.dtype
        for p in want:
            for n in want[p]:
                w = bridge.leaf_to_torch(np.asarray(want[p][n]))
                assert got[p][n].dtype == w.dtype and got[p][n].shape == w.shape
                assert torch.equal(got[p][n].view(torch.int16) if dtype == "bfloat16"
                                   else got[p][n],
                                   w.view(torch.int16) if dtype == "bfloat16" else w), (p, n)


def test_fold_mean_matches_jnp_mean_bitwise():
    rng = np.random.default_rng(0)
    for k in (2, 3, 5, 7):
        x = rng.normal(size=(k, 3, 257)).astype(np.float32)
        for dt in (jnp.float32, jnp.bfloat16):
            want = np.asarray(jnp.asarray(x, dt).mean(0, keepdims=True))
            got = tpipe.fold_mean(bridge.leaf_to_torch(np.asarray(jnp.asarray(x, dt))))
            w = bridge.leaf_to_torch(want)
            assert got.dtype == w.dtype, (k, dt)
            assert torch.equal(got.view(torch.int16), w.view(torch.int16)) if dt == jnp.bfloat16 \
                else torch.equal(got, w), (k, dt)


def test_serving_errors_match_reference(adapters, tmp_path):
    """A model-name mismatch and an out-of-range fold raise as in tst."""
    jdir, tdir = adapters
    for args, fold, match in ((["model.name=small"], "0", "trained on model 'tiny'"),
                              ([], "2", r"--fold 2 out of range: checkpoint has k=2")):
        jcfg = config_mod.resolve(None, None, _args(tmp_path, "synthetic:0.5", *args))
        tcfg = tconfig.resolve(None, None, _args(tmp_path, "synthetic:0.5", *args))
        spec, _ = jpipe.build_model(jcfg, ByteTokenizer())
        with pytest.raises(ValueError, match=match):
            jpipe.load_adapter_lora(jdir, jcfg, spec, fold=fold)
        with pytest.raises(ValueError, match=match):
            tpipe.load_adapter_lora(tdir, tcfg, tpipe.model_spec(tcfg, ByteTokenizer()),
                                    fold=fold)


def test_legacy_stamp_falls_back_to_the_serving_config(adapters, tmp_path):
    """A checkpoint without extra.json, or with a legacy stamp without
    ``k``: k and the LoRA geometry come from the serving config. tst agrees
    on the first; on the second it raises UnboundLocalError (a local import
    in ``_read_adapter_meta``'s first branch shadows ``lora_spec_from_cfg``
    for the whole function, tst/train/pipeline.py:665-675), a defect the
    port does not copy: it takes the fallback the reference's comment
    names."""
    args = _args(tmp_path, "synthetic:0.5", "data.k=3", "lora.rank=8")
    jcfg, tcfg = config_mod.resolve(None, None, args), tconfig.resolve(None, None, args)
    for stamp in (None, {"step": 3}):
        legacy = tmp_path / f"legacy_{stamp is None}"
        os.makedirs(legacy)
        if stamp is not None:
            with open(legacy / "extra.json", "w") as f:
                json.dump(stamp, f)
        tk, tls = tpipe._read_adapter_meta(str(legacy), tcfg, torch.float32)
        assert (tk, tls.rank, tls.alpha, tls.targets, tls.dtype) == (
            3, 8, tcfg.lora.alpha, tuple(tcfg.lora.targets), torch.float32)
        if stamp is None:
            k, ls = jpipe._read_adapter_meta(str(legacy), jcfg, jnp.float32)
            assert (k, ls.rank, ls.alpha, ls.targets) == (tk, tls.rank, tls.alpha, tls.targets)
        else:
            with pytest.raises(UnboundLocalError):
                jpipe._read_adapter_meta(str(legacy), jcfg, jnp.float32)
