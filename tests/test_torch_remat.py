"""Remat (``model.remat``) in the port: each of the reference's seven modes
(tst/models/decoder.py:274-319) changes what the backward keeps, never a
number. As tests/test_remat_policies.py holds the reference, every mode's
loss and LoRA gradients equal those of no remat, plain and packed rows, on
the dense path and through the attention kernel's Function (its plain
version on the CPU); here they are bit-equal, the recomputation running the
same operators on the same inputs. The modes that keep the kernel's
(output, lse) do not run its forward again in the backward. f32 on the CPU.
"""

import dataclasses

import pytest
import torch

from tst_torch.kernels import flash_attention as tfa
from tst_torch.models import decoder as tdec
from tst_torch.models import lora as tlora
from tst_torch.models.spec import spec_by_name
from tst_torch.train import sft as tsft

SPEC = dataclasses.replace(spec_by_name("tiny"), dtype=torch.float32)
LSPEC = tlora.LoraSpec(rank=4, alpha=8.0, dtype=torch.float32,
                       targets=("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj"))
MODES = [True, "full", "dots", "dots_attn", "dots_flash", "light", "attn", "flash"]
#: modes whose backward runs the kernel's forward again, on the kernel path
RERUN = {True, "full", "dots"}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(packed):
    g = torch.Generator().manual_seed(0)
    s = 256 if packed else 128
    tokens = torch.randint(0, SPEC.vocab_size, (2, s), generator=g)
    base = tdec.init_params(torch.Generator().manual_seed(1), SPEC)
    lora = tlora.init_lora(torch.Generator().manual_seed(2), SPEC, LSPEC)
    lora = tsft.tree_map(lambda t: t + 0.01, lora)  # B nonzero: A gets gradients too
    mask = torch.zeros(2, s)
    if packed:  # two segments a row, one answer window each
        seg = torch.tensor([[0, 128] + [tfa.SEG_PAD] * 6] * 2, dtype=torch.int32)
        pos = torch.tensor([[99, 227], [90, 200]])
        for b in range(2):
            for p in pos[b].tolist():
                mask[b, p + 1:p + 5] = 1.0
    else:
        seg, pos = None, torch.full((2,), 99)
        mask[:, 100:104] = 1.0
    return base, lora, tokens, mask, pos, seg


def _loss_and_grads(remat, use_pallas, packed):
    base, lora, tokens, mask, pos, seg = _inputs(packed)
    leaves = tsft.tree_map(lambda t: t.requires_grad_(True), lora)
    loss = tsft.sft_loss_window(base, leaves, tokens, mask, pos, 4, SPEC, LSPEC,
                                use_pallas=use_pallas, remat=remat, seg_starts=seg)
    grads = torch.autograd.grad(loss, tsft.tree_leaves(leaves))
    return loss.detach(), grads


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("remat", MODES)
def test_remat_modes_match_no_remat(remat, use_pallas, packed):
    loss0, g0 = _loss_and_grads(False, use_pallas, packed)
    loss1, g1 = _loss_and_grads(remat, use_pallas, packed)
    assert torch.equal(loss1, loss0)
    assert len(g0) == len(g1) == 2 * len(LSPEC.targets)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b) and a.abs().max() > 0


@pytest.mark.parametrize("remat", MODES)
def test_flash_residuals_kept_where_the_mode_says(remat, monkeypatch):
    """Forward calls of the attention operator in one loss and backward: one
    a layer, and a second a layer only where the mode recomputes the kernel
    (full, dots). Kept residuals come back from the selective-checkpoint
    cache, through the one autograd Function."""
    calls = []
    reference = tfa.flash_attention_reference

    def counting(*args, **kw):
        calls.append(1)
        return reference(*args, **kw)

    monkeypatch.setattr(tfa, "flash_attention_reference", counting)
    _loss_and_grads(remat, True, False)
    assert len(calls) == SPEC.n_layers * (2 if remat in RERUN else 1)


def test_trainer_step_under_remat():
    """FoldTrainer(remat=...) runs its step under the mode: fold-stacked
    adapters, the same per-fold losses and gradients as without."""
    base, _, tokens, mask, pos, _ = _inputs(False)
    out = []
    for remat in (False, "dots_flash"):
        trainer = tsft.FoldTrainer(SPEC, LSPEC, 2, use_pallas=True, remat=remat, t_max=4)
        lora, _ = trainer.init_state(torch.Generator().manual_seed(3))
        lora = tsft.tree_map(lambda t: t + 0.01, lora)
        out.append(trainer.loss_and_grads(base, lora, tokens[None].expand(2, -1, -1),
                                          mask[None].expand(2, -1, -1),
                                          pos[None].expand(2, -1)))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(tsft.tree_leaves(g0), tsft.tree_leaves(g1)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["bogus", "Full", 2])
def test_unknown_remat_mode_rejected(mode):
    with pytest.raises(ValueError, match="unknown remat mode"):
        _loss_and_grads(mode, False, False)
    with pytest.raises(ValueError, match="unknown remat mode"):
        tsft.FoldTrainer(SPEC, LSPEC, 2, remat=mode)
