# The port's own copy of tst/data/adapters/_hf.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Shared helpers for loading HuggingFace-format datasets (offline-friendly)."""

from __future__ import annotations

import os
from typing import Iterable, Optional


def load_rows(source, split: Optional[str] = None, config: Optional[str] = None):
    """Resolve ``source`` into an iterable of row dicts.

    Accepts: an already-loaded ``datasets.Dataset`` (or any iterable of
    dicts), a ``load_from_disk`` directory, a local dataset script/data dir,
    or an HF hub id (only works with network/cache, which this environment
    lacks — callers get a clear error instead of a hang).
    """
    if source is None:
        raise ValueError("no dataset source given and no network available")
    if hasattr(source, "features") or (
        not isinstance(source, (str, os.PathLike)) and hasattr(source, "__iter__")
    ):
        return source
    import datasets  # local import: keep module importable without datasets

    path = str(source)
    if os.path.isdir(path):
        # Either a save_to_disk dir or a dir of parquet/json files.
        state = os.path.join(path, "state.json")
        info = os.path.join(path, "dataset_info.json")
        if os.path.exists(state) or os.path.exists(info):
            ds = datasets.load_from_disk(path)
        else:
            ds = datasets.load_dataset(path, config, split=split)
            return ds
        if split and not isinstance(ds, datasets.Dataset):
            ds = ds[split]
        return ds
    if path.endswith(".jsonl") or path.endswith(".json"):
        return datasets.load_dataset("json", data_files=path, split="train")
    if path.endswith(".parquet"):
        return datasets.load_dataset("parquet", data_files=path, split="train")
    try:
        return datasets.load_dataset(path, config, split=split)
    except Exception as e:  # hub ids need network; fail with actionable advice
        raise RuntimeError(
            f"could not load {path!r} as a local path or HF hub id "
            f"({type(e).__name__}). If this is a hub id, note this "
            f"environment has no network egress — download the dataset "
            f"elsewhere and pass a local directory / jsonl / parquet path."
        ) from e


def first_present(row: dict, *keys, default=None):
    for k in keys:
        if k in row and row[k] is not None:
            return row[k]
    return default
