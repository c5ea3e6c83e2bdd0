# The port's own copy of tst/io/outputs.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Output artifacts: s(x) tables, debiased splits, reports.

The reference's released artifacts define the output surface (reference
README.md:14-15): a per-sample bias-score table and a debiased benchmark
split in HF-dataset layout (mirroring ``nyu-visionx/VSI-Bench``'s debiased
config). Formats: JSONL always; Parquet when pyarrow is available.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence

import numpy as np

from tst_torch.data.schema import BlindDataset


def _try_parquet(rows: Dict[str, list], path: str) -> bool:
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        return False
    pq.write_table(pa.table(rows), path)
    return True


def write_sx_table(
    out_dir: str,
    ds: BlindDataset,
    s_x: np.ndarray,
    fold_id: np.ndarray,
    pred: Optional[np.ndarray] = None,
    extra: Optional[Dict[str, np.ndarray]] = None,
) -> str:
    """Per-sample bias-score table → ``sx.jsonl`` (+ ``sx.parquet``)."""
    os.makedirs(out_dir, exist_ok=True)
    n = len(ds)
    cols: Dict[str, list] = {
        "id": [s.id for s in ds],
        "category": [s.category for s in ds],
        "answer_type": [s.answer_type for s in ds],
        "answer": [s.answer for s in ds],
        "s_x": [None if np.isnan(v) else float(v) for v in np.asarray(s_x, np.float32)],
        "fold": [int(f) for f in fold_id],
    }
    if pred is not None:
        cols["pred"] = [int(p) for p in pred]
    for k, v in (extra or {}).items():
        cols[k] = [float(x) for x in v]
    path = os.path.join(out_dir, "sx.jsonl")
    with open(path, "w") as f:
        for i in range(n):
            f.write(json.dumps({k: cols[k][i] for k in cols}) + "\n")
    _try_parquet(cols, os.path.join(out_dir, "sx.parquet"))
    return path


def write_debiased_split(
    out_dir: str,
    ds: BlindDataset,
    keep_mask: Sequence[bool],
    audit: Optional[Dict] = None,
) -> str:
    """Surviving samples → ``debiased.jsonl`` + prune audit trail.

    The debiased split mirrors the reference's released artifact
    (reference README.md:14); the audit records what IBP removed and why.
    """
    os.makedirs(out_dir, exist_ok=True)
    keep = np.asarray(keep_mask, bool)
    kept = ds.subset(np.flatnonzero(keep))
    path = os.path.join(out_dir, "debiased.jsonl")
    kept.save_jsonl(path)
    removed = ds.subset(np.flatnonzero(~keep))
    removed.save_jsonl(os.path.join(out_dir, "removed.jsonl"))
    if audit is not None:
        with open(os.path.join(out_dir, "ibp_audit.json"), "w") as f:
            json.dump(audit, f, indent=2, default=float)
    return path


def write_report(out_dir: str, report: Dict, name: str = "report.json") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=float)
    return path
