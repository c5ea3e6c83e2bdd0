"""BENCHMARK.json against the benchmark's contract, the harness's lookups by
name, and the operation counts against hand counts."""

from __future__ import annotations

import json
import re

import pytest

from portbench import flops, harness
from portbench.tests.tiny import REPO

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(1 <= len(w) <= 200 for w in BENCH["command"])
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_the_contract_keys_and_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (REPO / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"]
    names = [x["name"] for x in metrics + BENCH["workloads"] + BENCH["configs"]]
    assert len(set(names)) == len(names)
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    c = harness.load_cell(cell)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    assert (REPO / "portbench" / "checks" / f"{cell}.json").is_file()


def test_the_harness_finds_each_file_by_name():
    cell = harness.load_cell("qwen2.5-7b.sft-512")
    assert cell.config["hidden_size"] == 3584 and cell.traffic["name"] == "sft-512"
    for m in BENCH["per_layer"]:
        assert callable(harness.load_reader(REPO, m["name"]))
    kernels = harness.load_kernels(REPO)
    assert {"attention", "matmul"} <= set(kernels)
    assert callable(getattr(flops, kernels["attention"]["count"]))
    for path in kernels["attention"]["launch_counters"].values():
        assert harness.counter(path) >= 0


def _cfg(d, L, h, kvh, f, v):
    return {"hidden_size": d, "num_hidden_layers": L, "num_attention_heads": h,
            "num_key_value_heads": kvh, "intermediate_size": f, "vocab_size": v}


LORA = {"rank": 2, "alpha": 4.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"]}


@pytest.mark.parametrize("L", [1, 3])
def test_train_flops_by_hand(L):
    """d=8, 2 heads of 4 over 1 KV head, ffn 16, vocab 10, 2 rows of 4
    tokens, t_max 2: every product counted by hand."""
    cfg = _cfg(8, L, 2, 1, 16, 10)
    traffic = {"folds": 1, "rows_per_fold": 2, "seq_len": 4, "t_max": 2, "lora": LORA}
    T = 8
    per_tok = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16  # q, k, v, o, gate, up, down
    fwd = 2 * per_tok * L * T
    dgrad = fwd - 2 * 8 * (8 + 4 + 4) * T
    attn_fwd = 4 * 4 * 2 * 10 * 2 * L  # 4·dh · heads · pairs · rows, each layer
    lora_fwd = 2 * 2 * ((8 + 8) + (8 + 4) + (8 + 4) + (8 + 8)) * L * T
    lora_bwd = 2 * lora_fwd - 2 * 2 * (8 + 8 + 8) * T
    head = 2 * 8 * 10 * 2 * 2
    want = fwd + dgrad + 3 * attn_fwd + lora_fwd + lora_bwd + 2 * head
    assert flops.train_step_flops(cfg, traffic) == want


@pytest.mark.parametrize("L", [1, 3])
def test_score_flops_and_attention_bounds_by_hand(L):
    cfg = _cfg(8, L, 2, 1, 16, 10)
    traffic = {"rows_per_call": 3, "seq_len": 4, "letters": 4, "lora": LORA}
    T = 12
    per_tok = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    want = (2 * per_tok * L * T + 2 * 2 * 56 * L * T + 4 * 4 * 2 * 10 * 3 * L
            + 2 * 8 * 4 * 3)
    assert flops.score_call_flops(cfg, traffic) == want
    b = flops.attention_bounds(flops.widths(cfg), rows=3, s=4)
    pairs = 10 * 2 * 3
    assert b["fwd"]["flops"] == 4 * 4 * pairs and b["dkv"]["flops"] == 8 * 4 * pairs
    assert b["dq"]["flops"] == 6 * 4 * pairs
    qb, kvb, stat = 3 * 4 * 8 * 2, 2 * 3 * 4 * 4 * 2, 3 * 2 * 4 * 4
    assert b["fwd"]["bytes"] == 2 * qb + kvb + stat
    assert b["dkv"]["bytes"] == 2 * qb + 2 * kvb + 2 * stat
    assert b["dq"]["bytes"] == 3 * qb + kvb + 2 * stat


def test_the_attention_is_counted_in_every_layer():
    """Qwen2.5-0.5B at 10 × 16,384: attention is most of the step, so a
    count with it in one layer only would be far lower."""
    cfg = json.loads((REPO / "portbench/configs/qwen2.5-0.5b.json").read_text())
    traffic = json.loads((REPO / "portbench/traffic/sft-16k.json").read_text())
    w = flops.widths(cfg)
    one = flops.attention_fwd_flops(w, 10, 16384)
    assert flops.train_step_flops(cfg, traffic) > 3 * one * 24 > 0.5 * flops.train_step_flops(
        cfg, traffic)
