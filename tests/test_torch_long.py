"""The long-context preset (BASELINE config 4, ``sft-videomme-long``) on the
port, at a CPU size: rows whose transcripts fill the bucket, k=5, batch 2 a
fold, remat, the byte tokenizer; and the held-out scorer's chunk at long
rows (``tst_torch.train.infer.scorer_batch``)."""

import json
import math
import sys
from pathlib import Path

import pytest
import torch

from tst_torch import cli
from tst_torch.train import infer as tinfer

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402  (the script's pure helpers)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seq_len,rows", [(128, 32), (512, 32), (1024, 16), (16384, 1),
                                          (32768, 1)])
def test_scorer_batch_keeps_the_token_budget(seq_len, rows):
    """32 rows up to 512 tokens (the reference's chunk), the same 16,384
    tokens a chunk beyond."""
    assert tinfer.scorer_batch(seq_len) == rows


def test_long_rows_fill_their_transcripts(tmp_path):
    from tst_torch.data.schema import BlindDataset

    path = chip_smoke.long_rows(str(tmp_path / "long.jsonl"), n=3, nbytes=2000)
    ds = BlindDataset.load_jsonl(path)
    assert len(ds) == 3 and all(1999 <= len(s.context) < 2020 for s in ds)
    assert [s.answer for s in ds] == ["A", "B", "C"] and all(len(s.options) == 4 for s in ds)


def test_long_preset_runs_with_remat_on_the_cpu(tmp_path):
    """The preset's geometry (k=5, batch 2 a fold) at a bucket of 256 with
    ~180-byte transcripts, under remat and without: at least 3 steps, finite
    losses, every row's s(x); remat moves no s(x) beyond f32 rounding."""
    rows = chip_smoke.long_rows(str(tmp_path / "rows.jsonl"), n=10, nbytes=180)
    sx = {}
    for remat in ("true", "false"):
        out = tmp_path / remat
        assert cli.main(["diagnose-sft", "--platform", "cpu", "--preset", "sft-videomme-long",
                         "--bench", rows, "--set", "model.name=tiny",
                         "--set", "model.dtype=float32", "--set", "model.tokenizer=byte",
                         "--set", f"model.remat={remat}", "--set", "data.max_len=256",
                         "--set", "optim.epochs=1", "--set", "rf.cross_check=false",
                         "--out", str(out)]) == 0
        report = json.loads((out / "report.json").read_text())
        sx[remat] = [json.loads(line)["s_x"]
                     for line in (out / "sx.jsonl").read_text().splitlines()]
        assert report["k"] == 5 and report["train_steps"] >= 3
        assert math.isfinite(report["final_loss"]) and len(sx[remat]) == 10
        assert all(0.0 <= x <= 1.0 for x in sx[remat])
    assert sx["true"] == pytest.approx(sx["false"], abs=1e-5)
