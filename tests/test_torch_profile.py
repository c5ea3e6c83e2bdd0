"""Item 17 of the port: ``tst_torch.aux.profile``'s ``trace`` (its spans:
``tests/test_torch_spans.py``), ``tst_torch.aux.flops`` against
``tst.aux.flops``, and ``--debug-nans``.

CPU runs at the ``tiny`` spec in f32: the trace's op summary reads CPU time
there (the card's run reads device time; chip_smoke.py phase 21).
"""

import json

import pytest
import torch

from tst.aux import flops as jflops
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst_torch import cli
from tst_torch.aux import flops as tflops
from tst_torch.aux import profile as tprofile
from tst_torch.models.lora import LoraSpec
from tst_torch.models.spec import spec_by_name
from tst_torch.train import sft as tsft

TINY_RUN = ["--platform", "cpu", "--bench", "synthetic:0.5", "--k", "2",
            "--set", "data.n=16", "--set", "optim.batch_size=4", "--set", "optim.epochs=1",
            "--set", "model.name=tiny", "--set", "model.dtype=float32",
            "--set", "data.max_len=128", "--set", "rf.cross_check=false"]


@pytest.fixture(autouse=True)
def _one_thread_and_no_debug_nans():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    tsft.set_debug_nans(False)


def test_trace_writes_a_trace_and_an_op_summary(tmp_path):
    with tprofile.trace(str(tmp_path / "prof")):
        x = torch.randn(64, 64)
        for _ in range(3):
            x = torch.tanh(x @ x)
    trace = json.loads((tmp_path / "prof" / tprofile.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    summary = json.loads((tmp_path / "prof" / tprofile.SUMMARY_FILE).read_text())
    names = [op["name"] for op in summary["top_ops"]]
    assert summary["time"] == "cpu" and "aten::mm" in names and "aten::tanh" in names
    mm = summary["top_ops"][names.index("aten::mm")]
    assert mm["calls"] == 3 and mm["total_us"] > 0


def test_trace_of_none_does_nothing(tmp_path):
    with tprofile.trace(None) as prof:
        torch.ones(3).sum()
    assert prof is None and not list(tmp_path.iterdir())


@pytest.mark.parametrize("remat", [False, True, "full", "dots", "dots_attn", "dots_flash",
                                   "light", "attn", "flash"])
@pytest.mark.parametrize("name,targets", [
    ("qwen2.5-0.5b", ("q_proj", "k_proj", "v_proj", "o_proj")),
    ("llama3-8b", ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
                   "down_proj"))])
def test_train_step_flops_equal_the_reference(name, targets, remat):
    want = jflops.train_step_flops(jdec.spec_by_name(name),
                                   jlora.LoraSpec(rank=16, targets=targets), 40, 512, 6,
                                   remat=remat)
    got = tflops.train_step_flops(spec_by_name(name), LoraSpec(rank=16, targets=targets),
                                  40, 512, 6, remat=remat)
    assert got == want


def test_cli_profile_dir_traces_diagnose_sft(tmp_path):
    assert cli.main(["diagnose-sft", *TINY_RUN, "--profile-dir", str(tmp_path / "prof"),
                     "--out", str(tmp_path / "run")]) == 0
    summary = json.loads((tmp_path / "prof" / tprofile.SUMMARY_FILE).read_text())
    assert summary["top_ops"] and (tmp_path / "prof" / tprofile.TRACE_FILE).exists()
    assert (tmp_path / "run" / "report.json").exists()


def test_debug_nans_passes_a_finite_run(tmp_path):
    assert cli.main(["diagnose-sft", *TINY_RUN, "--debug-nans",
                     "--out", str(tmp_path / "run")]) == 0
    assert tsft.DEBUG_NANS


def test_debug_nans_raises_on_an_injected_nan_loss(tmp_path, monkeypatch):
    real = tsft.FoldTrainer.loss_and_grads

    def nan_at_step_2(self, *args, step=None, **kw):
        losses, grads = real(self, *args, step=step, **kw)
        if step == 2:
            losses = losses.clone()
            losses[1] = float("nan")
        return losses, grads

    monkeypatch.setattr(tsft.FoldTrainer, "loss_and_grads", nan_at_step_2)
    with pytest.raises(FloatingPointError, match="non-finite loss at step 2, fold 1"):
        cli.main(["diagnose-sft", *TINY_RUN, "--debug-nans", "--out", str(tmp_path / "a")])
    # without the flag the same run goes on
    assert cli.main(["diagnose-sft", *TINY_RUN, "--out", str(tmp_path / "b")]) == 0


def test_check_finite_names_a_gradient():
    losses = torch.zeros(3)
    grads = {"q": {"a": torch.zeros(3, 2, 4), "b": torch.zeros(3, 4, 2)}}
    tsft.check_finite(losses, grads, step=5)
    grads["q"]["b"][2, 1, 0] = float("inf")
    with pytest.raises(FloatingPointError, match="adapter gradient at step 5, fold 4"):
        tsft.check_finite(losses, grads, step=5, fold0=2)
