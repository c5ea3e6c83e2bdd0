"""The port's throughput bench (tst_torch/bench.py) against the reference's
(``bench.py``).

(a) the contract: the bench's ``main(["--platform", "cpu"])`` in a
subprocess at the reference's CPU overrides (one timed and one untimed
step), with ``tiny`` put in for the CPU model ``small`` (whose plain
attention at the legs' 20 rows of 512 tokens and 15 of 1024 takes minutes
on one thread), prints one JSON line with the reference's keys,
``backend`` "cpu", and none of the card's keys (~35 s on one thread); (b) the workload bit-equal to
what ``tst``'s own functions build from ``bench.py``'s calls; (c) the
record's formulas on fixed leg numbers; (d) ``--platform gpu`` raises
without CUDA; (e) ``train_step_flops`` equal to ``tst``'s at each leg's
rows, length and remat mode.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tst.aux import flops as jflops
from tst.data.folds import kfold_assign
from tst.data.packing import make_packed_fold_batches, pack_fold_datasets
from tst.data.synthetic import make_synthetic_mcq
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.train.sft import make_fold_batches
from tst_torch import bench
from tst_torch.aux import flops as tflops
from tst_torch.models.lora import LoraSpec
from tst_torch.models.spec import spec_by_name

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the keys of the record on any backend (bench.py:559-603, less its
#: xla_programs_* keys)
CONTRACT_KEYS = {
    "metric", "value", "unit", "vs_baseline", "baseline", "headline_config",
    "unpacked_samples_per_sec_per_chip", "model", "k", "batch_per_fold", "seq_len", "backend",
    "n_chips", "fold_sequential_samples_per_sec_per_chip", "compile_s_fold_parallel",
    "compile_cache_hit_fold_parallel", "compile_s_single_fold", "step_hbm_gb",
    "fold_finetunes_per_hour_per_chip", "packed_samples_per_sec_per_chip", "pack_len",
    "pack_fill_fraction", "pack_batch_rows_per_fold"}
#: the keys only the card's legs write (MFU, the 8B, long and decode legs)
CARD_KEYS = {
    "mfu", "tflops_per_s", "packed_mfu", "llama3_8b_int8_samples_per_sec_per_chip",
    "llama3_8b_mfu", "llama3_8b_base_hbm_gb", "llama3_8b_step_hbm_gb",
    "llama3_8b_k5_fold_parallel_samples_per_sec_per_chip",
    "llama3_8b_packed_samples_per_sec_per_chip", "llama3_8b_k5_packed_samples_per_sec_per_chip",
    "longseq_tokens_per_s", "longseq_len", "longseq_32k_tokens_per_s", "decode_tokens_per_s",
    "decode_batch", "decode_step_tokens_per_s", "llama3_8b_int4_decode_step_tokens_per_s"}


def test_cli_prints_the_contract_line_on_the_cpu():
    env = dict(os.environ, TST_BENCH_STEPS="1", TST_BENCH_WARMUP="1", OMP_NUM_THREADS="1")
    code = ("import sys, tst_torch.bench as b; b.bench_model = lambda on_card: 'tiny'; "
            "sys.exit(b.main(['--platform', 'cpu']))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1, proc.stdout[:1000]
    rec = json.loads(lines[0])
    assert set(rec) == CONTRACT_KEYS and not set(rec) & CARD_KEYS
    assert rec["metric"] == "blind_sft_samples_per_sec_per_chip"
    assert rec["unit"] == "samples/s/chip" and rec["backend"] == "cpu" and rec["n_chips"] == 1
    assert rec["value"] > 0 and rec["vs_baseline"] > 0
    assert rec["fold_finetunes_per_hour_per_chip"] > 0
    assert rec["model"] == "tiny" and (rec["k"], rec["batch_per_fold"], rec["seq_len"]) == (
        5, 4, 512)
    assert rec["pack_len"] == 1024 and rec["pack_batch_rows_per_fold"] == 3
    assert rec["step_hbm_gb"] is None and rec["compile_cache_hit_fold_parallel"] is None
    assert "skipped" not in proc.stderr


def test_workload_is_bit_equal_to_the_references():
    """bench.py:97-102, 173-176, 197-198, 275-276, 320, 347-350, 450 through
    ``tst``'s functions, against :func:`tst_torch.bench.bench_workload`."""
    steps, warmup = 12, 3
    w = bench.bench_workload(False, steps, warmup)
    ds = make_synthetic_mcq(n=256, bias_fraction=0.5, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=512)
    fold_id = kfold_assign(ds, 5, seed=0)
    batches = make_fold_batches(fold_id, 5, 4, epochs=50, seed=0)[: steps + warmup + 1]
    fp = pack_fold_datasets(tb, fold_id, 5, 1024)
    pbatches = make_packed_fold_batches(fp.n_rows, 3, epochs=50, seed=0)[: steps + warmup + 1]
    idx = np.asarray(pbatches[warmup: warmup + steps])
    n_real = int(fp.n_segs[np.arange(5)[None, :, None], idx].sum())
    fid2 = kfold_assign(ds, 2, seed=0)

    assert [s.id for s in w.ds] == [s.id for s in ds]
    for name in ("tokens", "loss_mask", "answer_pos", "lengths", "gold", "n_options",
                 "option_token_ids"):
        np.testing.assert_array_equal(getattr(w.tb, name), getattr(tb, name), err_msg=name)
    np.testing.assert_array_equal(w.fold_id, fold_id)
    assert w.t_max == int(np.max(tb.lengths - tb.answer_pos - 1))
    np.testing.assert_array_equal(w.batches, batches)
    np.testing.assert_array_equal(w.pbatches, pbatches)
    assert w.n_real == n_real > 0
    np.testing.assert_array_equal(w.fid2, fid2)
    np.testing.assert_array_equal(w.b8, make_fold_batches(fid2, 2, 2, epochs=10, seed=0))
    np.testing.assert_array_equal(w.b5, make_fold_batches(fold_id, 5, 1, epochs=5, seed=0))
    np.testing.assert_array_equal(w.blong, make_fold_batches(fold_id, 2, 1, epochs=10, seed=0))
    pairs = [(w.pack, fp)]
    for kk in (2, 5):
        fp8 = pack_fold_datasets(tb, fid2 if kk == 2 else kfold_assign(ds, kk, seed=0), kk,
                                 1024)
        pb8 = make_packed_fold_batches(fp8.n_rows, 1, epochs=20, seed=0)
        mine, mine_pb8 = w.packed8[kk]
        np.testing.assert_array_equal(mine_pb8, pb8)
        nsamp = int(fp8.n_segs[np.arange(kk)[None, :, None], np.asarray(pb8[2:8])].sum())
        assert bench.real_samples(mine.n_segs, pb8[2:8]) == nsamp
        pairs.append((mine, fp8))
    for mine, ref in pairs:
        for name in ("tokens", "loss_mask", "seg_starts", "answer_pos", "n_segs", "n_rows"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name), err_msg=name)
        assert mine.pack_len == ref.pack_len and mine.fill_fraction == ref.fill_fraction


def test_steps_and_model_read_as_the_reference_reads_them():
    assert bench.bench_steps({}) == (12, 3)
    assert bench.bench_steps({"TST_BENCH_STEPS": "2", "TST_BENCH_WARMUP": "0"}) == (2, 1)
    assert bench.bench_model(True) == "qwen2.5-0.5b"
    assert bench.bench_model(False) == "small"


def _leg(sps, mfu=None, **kw):
    return {"samples_per_s": sps, "step_ms": 100.0, "compile_s": 12.34,
            "compile_cache_hit": True, "flops_per_step": 5e13, "mfu": mfu, "hbm_gb": 7.5, **kw}


@pytest.mark.parametrize("packed_sps,headline",
                         [(150.0, "packed"), (90.0, "unpacked"), (None, "unpacked")])
def test_record_formulas_are_the_references(packed_sps, headline):
    """bench.py:553-592 on fixed leg numbers: the headline is the better of
    unpacked and packed, over the fold-sequential rate; fine-tunes an hour
    are value · 3600 / (3 · ⌊512 · 4/5⌋)."""
    par = _leg(120.0, mfu=0.31)
    packed = None if packed_sps is None else _leg(packed_sps, mfu=0.4, fill=0.8974,
                                                  pack_len=1024, batch_rows=3)
    rec = bench.bench_record("qwen2.5-0.5b", "cuda", par, packed, 40.0, 3.21)
    best = max(120.0, packed_sps or 0.0)
    assert rec["headline_config"] == headline
    assert rec["value"] == round(best, 3)
    assert rec["vs_baseline"] == round(best / 40.0, 3)
    assert rec["fold_finetunes_per_hour_per_chip"] == round(best * 3600.0 / (3 * 409), 1)
    assert rec["unpacked_samples_per_sec_per_chip"] == 120.0
    assert rec["fold_sequential_samples_per_sec_per_chip"] == 40.0
    assert rec["compile_s_fold_parallel"] == 12.3 and rec["compile_s_single_fold"] == 3.2
    assert rec["mfu"] == 0.31 and rec["tflops_per_s"] == round(5e13 / 0.1 / 1e12, 1)
    assert rec["n_chips"] == 1 and rec["backend"] == "cuda" and rec["step_hbm_gb"] == 7.5
    assert not any(key.startswith("xla_programs") for key in rec)
    if packed is None:
        assert "packed_samples_per_sec_per_chip" not in rec and "packed_mfu" not in rec
    else:
        assert rec["packed_samples_per_sec_per_chip"] == packed_sps
        assert (rec["pack_fill_fraction"], rec["packed_mfu"]) == (0.897, 0.4)


def test_record_carries_every_card_leg():
    llama8b = {"samples_per_s": 9.87654, "mfu": 0.41234, "base_hbm_gb": 8.04, "hbm_gb": 12.5,
               "compile_s": 3.0, "k5_samples_per_s": 8.5, "packed_samples_per_s": 13.9,
               "k5_packed_samples_per_s": 12.1}
    rec = bench.bench_record(
        "qwen2.5-0.5b", "cuda", _leg(120.0, mfu=0.3),
        _leg(150.0, mfu=0.4, fill=0.9, pack_len=1024, batch_rows=3), 40.0, 3.0, llama8b,
        {"step_tokens_per_s": 1100.5, "batch": 32}, {"tokens_per_s": 30000.0, "seq_len": 16384},
        {"tokens_per_s": 20000.0, "seq_len": 32768},
        {"tokens_per_s": 900.0, "batch": 32, "max_new": 16, "step_tokens_per_s": 2500.0})
    assert set(rec) == CONTRACT_KEYS | CARD_KEYS
    assert rec["llama3_8b_int8_samples_per_sec_per_chip"] == 9.877
    assert rec["llama3_8b_mfu"] == 0.412
    assert rec["llama3_8b_k5_packed_samples_per_sec_per_chip"] == 12.1
    assert rec["longseq_len"] == 16384 and rec["longseq_32k_tokens_per_s"] == 20000.0
    assert rec["llama3_8b_int4_decode_step_tokens_per_s"] == 1100.5
    assert rec["decode_step_tokens_per_s"] == 2500.0 and rec["decode_batch"] == 32


def test_gpu_platform_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default platform runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run_bench("gpu")


#: each leg's (model, rows a step, tokens a row, remat)
LEGS = [
    ("qwen2.5-0.5b", 20, 512, "dots"),  # fold-parallel
    ("qwen2.5-0.5b", 15, 1024, "dots"),  # packed
    ("qwen2.5-0.5b", 4, 512, "dots"),  # one fold of the fold-sequential baseline
    ("llama3-8b", 4, 512, "dots"),  # 8B k=2
    ("llama3-8b", 5, 512, "attn"),  # 8B k=5
    ("llama3-8b", 2, 1024, "dots"),  # 8B packed k=2
    ("llama3-8b", 5, 1024, "attn"),  # 8B packed k=5
    ("qwen2.5-0.5b", 2, 16384, "flash"),  # long
    ("qwen2.5-0.5b", 2, 32768, "flash"),  # 32k
    ("small", 20, 512, False),  # the CPU's fold-parallel
]


@pytest.mark.parametrize("name,rows,seq,remat", LEGS)
def test_leg_flops_equal_the_reference(name, rows, seq, remat):
    t_max = bench.bench_workload(True, 1, 1).t_max
    want = jflops.train_step_flops(jdec.spec_by_name(name), jlora.LoraSpec(rank=16, alpha=32.0),
                                   n_rows=rows, seq=seq, t_max=t_max, remat=remat)
    got = tflops.train_step_flops(spec_by_name(name), LoraSpec(rank=16, alpha=32.0),
                                  n_rows=rows, seq=seq, t_max=t_max, remat=remat)
    assert got == want
