"""The port's training checkpoints (tst_torch.aux.ckpt) and FoldTrainer.fit's
resume, against tst's.

Round trips are bit for bit in bf16 and f32. A fit interrupted by
``fail_after_step`` and resumed from its checkpoint gives the adapters,
AdamW state and logged losses of an uninterrupted fit, bit for bit (f32,
the CPU: the same operations in the same order), with and without LoRA
dropout (its masks follow the restored step count). The checkpoint layout
and the ``extra.json`` stamp of a diagnose-sft run equal tst's. A save that
fails midway leaves the previous checkpoint readable.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tst import config as config_mod
from tst.data.adapters import load_benchmark
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train import pipeline as jpipe
from tst.train import sft as jsft
from tst_torch import bridge
from tst_torch import config as tconfig
from tst_torch.aux import ckpt
from tst_torch.data.adapters import load_benchmark as tload_benchmark
from tst_torch.models import lora as tlora
from tst_torch.models.hf_load import SafetensorsFile
from tst_torch.models.spec import ModelSpec
from tst_torch.train import pipeline as tpipe
from tst_torch.train import sft as tsft

TINY = dataclasses.replace(jdec.spec_by_name("tiny"), dtype=jnp.float32)
PORT_TINY = ModelSpec(**{**dataclasses.asdict(TINY), "dtype": torch.float32})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    """(params, tokens, loss_mask, answer_pos, t_max, batches) as tensors: 16
    rows of 128 tokens, k=2, 7 steps."""
    tb = tokenize_dataset(load_benchmark("synthetic:0.5", n=16, seed=0), ByteTokenizer(),
                          max_len=128)
    params = bridge.to_torch(jax.tree.map(np.asarray, jdec.init_params(jax.random.key(0), TINY)))
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    batches = tsft.make_fold_batches(np.arange(16, dtype=np.int32) % 2, 2, 4, 4, seed=0)[:7]
    return (params, torch.from_numpy(tb.tokens), torch.from_numpy(tb.loss_mask),
            torch.from_numpy(tb.answer_pos), t_max, batches)


def _trainer(t_max, dropout=0.0, dtype=torch.float32):
    lspec = tlora.LoraSpec(rank=2, alpha=4.0, dtype=dtype, dropout=dropout)
    return tsft.FoldTrainer(PORT_TINY, lspec, 2, lr=1e-2, total_steps=7, t_max=t_max)


def _state(trainer, seed=1):
    lora, opt = trainer.init_state(torch.Generator().manual_seed(seed))
    for ab in lora.values():  # B nonzero, so every leaf moves
        ab["b"] = 0.05 * torch.randn(ab["b"].shape, generator=torch.Generator().manual_seed(seed)
                                     ).to(ab["b"].dtype)
    return lora, opt


def _equal(a, b):
    la, lb = tsft.tree_leaves(a), tsft.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                                           else x, y.view(torch.int16)
                                           if y.dtype == torch.bfloat16 else y)
        for x, y in zip(la, lb))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_save_load_roundtrip_bitwise(tmp_path, data, dtype):
    trainer = _trainer(data[4], dtype=dtype)
    lora, opt = _state(trainer)
    opt = tsft.AdamWState(5, tsft.tree_map(lambda t: torch.randn_like(t.float()).to(dtype), lora),
                          tsft.tree_map(lambda t: torch.rand_like(t.float()).to(dtype), lora))
    path = tmp_path / "ck"
    ckpt.save_train_state(str(path), lora, opt, extra=trainer.ckpt_extra(step=5))
    assert sorted(os.listdir(path)) == [ckpt.EXTRA_FILE, ckpt.STATE_FILE]
    assert sorted(os.listdir(tmp_path)) == ["ck"]  # no temporary left behind
    got_lora, got_opt, extra = ckpt.load_train_state(str(path), lora, opt)
    assert _equal(got_lora, lora) and _equal(got_opt.mu, opt.mu) and _equal(got_opt.nu, opt.nu)
    assert got_opt.count == 5 and extra == trainer.ckpt_extra(step=5)
    only_lora, no_opt, _ = ckpt.load_train_state(str(path), lora)  # the adapters alone
    assert _equal(only_lora, lora) and no_opt is None
    bad = tsft.tree_map(lambda t: t[:1], lora)
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_train_state(str(path), bad, opt)


@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_resume_after_failure_is_bitwise_uninterrupted(tmp_path, data, dropout):
    """Fail after step 5 of 7 (checkpoints every 2 steps: the last at step
    4), resume from fresh adapters: the final state and the resumed steps'
    losses equal the uninterrupted fit's, bit for bit."""
    params, tokens, mask, pos, t_max, batches = data
    trainer = _trainer(t_max, dropout)
    kw = dict(all_pos=pos, log_every=1)
    ref_lora, ref_opt, ref_log = trainer.fit(params, *_state(trainer), tokens, mask, batches, **kw)
    path = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure after step 5"):
        trainer.fit(params, *_state(trainer), tokens, mask, batches, checkpoint_dir=path,
                    checkpoint_every=2, fail_after_step=5, **kw)
    with open(os.path.join(path, ckpt.EXTRA_FILE)) as f:
        assert json.load(f)["step"] == 4
    lora, opt, log = trainer.fit(params, *_state(trainer, seed=9), tokens, mask, batches,
                                 checkpoint_dir=path, checkpoint_every=2, **kw)
    assert _equal(lora, ref_lora) and _equal(opt.mu, ref_opt.mu) and _equal(opt.nu, ref_opt.nu)
    assert opt.count == ref_opt.count == 7
    assert log.losses == ref_log.losses[4:] and log.fold_losses == ref_log.fold_losses[4:]
    assert log.steps == 7
    # the final save holds the last step; a fit over a finished checkpoint runs nothing
    with open(os.path.join(path, ckpt.EXTRA_FILE)) as f:
        assert json.load(f) == trainer.ckpt_extra(step=7)
    again, _, log2 = trainer.fit(params, *_state(trainer, seed=3), tokens, mask, batches,
                                 checkpoint_dir=path, **kw)
    assert _equal(again, ref_lora) and log2.losses == []


def test_torn_save_keeps_the_previous_checkpoint(tmp_path, data, monkeypatch):
    trainer = _trainer(data[4])
    lora, opt = _state(trainer)
    path = str(tmp_path / "ck")
    ckpt.save_train_state(path, lora, opt, extra=trainer.ckpt_extra(step=2))
    newer = tsft.tree_map(lambda t: t + 1, lora)

    def torn(file, tensors, metadata=None):  # half the file, then the crash
        with open(file, "wb") as f:
            f.write(b"\0" * 100)
        raise OSError("disk gone")

    monkeypatch.setattr(ckpt, "write_safetensors", torn)
    with pytest.raises(OSError, match="disk gone"):
        ckpt.save_train_state(path, newer, opt, extra=trainer.ckpt_extra(step=4))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    got, _, extra = ckpt.load_train_state(path, lora, opt)
    assert _equal(got, lora) and extra["step"] == 2


def _cfg(out_dir, config, *extra):
    return config.resolve(None, None, [
        "model.name=tiny", "model.dtype=float32", "data.bench=synthetic:0.5", "data.n=24",
        "data.max_len=128",
        "data.k=2", "optim.batch_size=4", "optim.epochs=2", "rf.cross_check=false",
        f"out_dir={out_dir}", *extra])


def test_diagnose_sft_checkpoint_layout_and_stamp_match_reference(tmp_path):
    """Both packages' diagnose-sft with checkpoint_dir: the same
    ``seed_{s}_epoch_{e:03d}`` directories and equal extra.json stamps."""
    jds = load_benchmark("synthetic:0.5", n=24, seed=0)
    jpipe.run_sft_diagnostic(jds, _cfg(tmp_path / "jout", config_mod,
                                       f"checkpoint_dir={tmp_path / 'jck'}"))
    tds = tload_benchmark("synthetic:0.5", n=24, seed=0)
    tpipe.run_sft_diagnostic(tds, _cfg(tmp_path / "tout", tconfig,
                                       f"checkpoint_dir={tmp_path / 'tck'}"),
                             torch.device("cpu"))
    dirs = sorted(os.listdir(tmp_path / "jck"))
    assert dirs == sorted(os.listdir(tmp_path / "tck")) == ["seed_0_epoch_000",
                                                            "seed_0_epoch_001"]
    for d in dirs:
        with open(tmp_path / "jck" / d / "extra.json") as f:
            want = json.load(f)
        with open(tmp_path / "tck" / d / "extra.json") as f:
            assert json.load(f) == want
    # the port's checkpoint holds the fold-stacked adapters and AdamW state
    sf = SafetensorsFile(str(tmp_path / "tck" / dirs[-1] / ckpt.STATE_FILE))
    assert sf.get("lora.q.a").shape[:2] == (2, TINY.n_layers) and "opt.nu.v.b" in sf.keys()
    assert int(sf.metadata["count"]) > 0


def test_ckpt_extra_matches_reference():
    jl = jlora.LoraSpec(rank=8, alpha=16.0, targets=("q_proj", "v_proj", "down_proj"))
    tl = tlora.LoraSpec(rank=8, alpha=16.0, targets=("q_proj", "v_proj", "down_proj"))
    want = jsft.FoldTrainer(TINY, jl, 3).ckpt_extra(step=11)
    assert tsft.FoldTrainer(PORT_TINY, tl, 3).ckpt_extra(step=11) == want
