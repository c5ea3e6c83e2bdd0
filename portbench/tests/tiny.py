"""A checkout of the benchmark with one tiny configuration and two tiny
cells added as data alone, for the CPU tests."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "a test-scale Qwen2 geometry", "reference": "qwen2",
    "model_type": "qwen2", "hidden_size": 64, "intermediate_size": 128,
    "num_hidden_layers": 2, "num_attention_heads": 4, "num_key_value_heads": 2,
    "max_position_embeddings": 2048, "rms_norm_eps": 1e-06, "rope_theta": 10000.0,
    "tie_word_embeddings": True, "torch_dtype": "bfloat16", "vocab_size": 384,
    "train_remat": False,
}
TRAIN = {
    "name": "tiny-train", "kind": "train", "folds": 2, "rows_per_fold": 4, "seq_len": 64,
    "pool_rows_per_fold": 16, "prompt_len": [16, 60], "target_len": [1, 2], "t_max": 2,
    "letters": 4,
    "lora": {"rank": 4, "alpha": 8.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"],
             "b_init_std": 0.0},
    "optim": {"lr": 0.0001, "warmup_frac": 0.03, "total_steps": 100, "end_value_frac": 0.05,
              "weight_decay": 0.0, "b1": 0.9, "b2": 0.999},
    "remat": False, "check_steps": 3, "trace_steps": 2, "reference_row_block": 4,
}
SCORE = {
    "name": "tiny-score", "kind": "score", "folds": 2, "rows_per_call": 16, "pool_calls": 2,
    "seq_len": 64, "prompt_len": [16, 63], "letters": 4, "n_options": [2, 4],
    "lora": {"rank": 4, "alpha": 8.0, "targets": ["q_proj", "k_proj", "v_proj", "o_proj"],
             "b_init_std": 0.01},
    "check_rows": 8, "trace_calls": 1, "reference_row_block": 4,
}
#: limits of the tiny cells, set as the benchmark's are: the largest reading
#: of bf16 on the CPU against the float32 reference over 13 seeds (loss
#: 0.0027, grad 0.0128, change 0.0053, prob 0.0141) and the smallest of the
#: float8 control over 3 (0.0097, 0.0384, 0.0186, 0.0699), by
#: ``python3 -m portbench.readings --device cpu`` on a root from make_root
LIMITS = {"tiny.tiny-train": {"loss": 0.006, "grad": 0.025, "change": 0.012},
          "tiny.tiny-score": {"prob": 0.04}}


def make_root(tmp: Path, limits=None) -> Path:
    """``tmp`` as a checkout: the repository's BENCHMARK.json and portbench/
    with the tiny configuration, its two mixes, the two cells and their
    limits added."""
    root = Path(tmp)
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "portbench" / "configs" / "tiny.json").write_text(json.dumps(TINY))
    bench["configs"].append({"name": "tiny", "source": "https://huggingface.co/Qwen/Qwen2.5-0.5B",
                             "file": "portbench/configs/tiny.json", "reduced": [], "why": "test"})
    for mix in (TRAIN, SCORE):
        (root / "portbench" / "traffic" / f"{mix['name']}.json").write_text(json.dumps(mix))
        cell = f"tiny.{mix['name']}"
        bench["workloads"].append({"name": cell, "config": "tiny", "traffic": mix["name"],
                                   "chips": 1, "why": "test"})
        lim = (limits or LIMITS)[cell]
        (root / "portbench" / "checks" / f"{cell}.json").write_text(json.dumps(
            {"numbers": {k: {"limit": v} for k, v in lim.items()}}))
        kind = mix["kind"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.endswith("." + ("sft-512" if kind == "train"
                                                          else "score-512"))
                                        for w in m["workloads"]):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
