"""Sequence packing: several short samples per fixed-shape row (a numpy copy
of ``tst/data/packing.py``, whose module imports the Pallas kernels and so
jax).

Samples are placed end to end in rows of ``pack_len`` tokens, first fit
decreasing, with per-row segment starts; the model confines attention to
each sample's segment and restarts RoPE positions at each start
(``tst_torch.kernels.flash_attention`` / ``tst_torch.models.decoder``
``seg_starts``), so a packed row is numerically a batch of independent
samples. Rows are packed per fold: fold f packs its own train split (rows
whose fold id is not f). Every function is bit-equal to its reference.
The reference's ``pad_rows_to`` (a row count pinned across IBP rounds so
the jitted step never retraces) is XLA machinery and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from tst_torch.data.tokenize import TokenBatch
from tst_torch.kernels.flash_attention import MAX_SEGS, SEG_PAD


@dataclasses.dataclass
class PackedBatch:
    """Fixed-shape packed rows for one fold's train split."""

    tokens: np.ndarray  # int32 [Np, L]
    loss_mask: np.ndarray  # float32 [Np, L]
    seg_starts: np.ndarray  # int32 [Np, MAX_SEGS] ascending; unused = SEG_PAD
    answer_pos: np.ndarray  # int32 [Np, MAX_SEGS] last prompt token; unused = -1
    n_segs: np.ndarray  # int32 [Np] real samples in each row
    sample_rows: np.ndarray  # int32 [Np, MAX_SEGS] source TokenBatch rows; -1 unused

    @property
    def n_rows(self) -> int:
        return self.tokens.shape[0]

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]


def pack_rows(tb: TokenBatch, rows: Sequence[int], pack_len: int,
              max_segs: int = MAX_SEGS) -> PackedBatch:
    """First-fit-decreasing packing of ``tb`` rows into ``pack_len`` rows:
    longest first (ties by row order), each into the first open row with
    room and a free segment slot. Tail space stays pad tokens, loss-masked."""
    if pack_len % 128:
        raise ValueError(f"pack_len {pack_len} must be a multiple of 128")
    if not 1 <= max_segs <= MAX_SEGS:
        raise ValueError(f"max_segs must be in [1, {MAX_SEGS}], got {max_segs}")
    rows = np.asarray(list(rows), np.int64)
    lengths = tb.lengths[rows].astype(np.int64)
    if int(lengths.max(initial=0)) > pack_len:
        bad = rows[lengths.argmax()]
        raise ValueError(
            f"sample row {bad} (len {int(lengths.max())}) exceeds pack_len "
            f"{pack_len} — re-tokenize with a smaller max_len or raise pack_len")
    order = np.lexsort((rows, -lengths))  # longest first, stable by row id

    bins: List[dict] = []  # {"used": int, "members": [(row, length)]}
    for oi in order:
        row, ln = int(rows[oi]), int(lengths[oi])
        for b in bins:
            if b["used"] + ln <= pack_len and len(b["members"]) < max_segs:
                b["members"].append((row, ln))
                b["used"] += ln
                break
        else:
            bins.append({"used": ln, "members": [(row, ln)]})

    np_rows = len(bins)
    tokens = np.full((np_rows, pack_len), tb.pad_id, np.int32)
    loss_mask = np.zeros((np_rows, pack_len), np.float32)
    seg_starts = np.full((np_rows, MAX_SEGS), SEG_PAD, np.int32)
    answer_pos = np.full((np_rows, MAX_SEGS), -1, np.int32)
    n_segs = np.zeros(np_rows, np.int32)
    sample_rows = np.full((np_rows, MAX_SEGS), -1, np.int32)
    for i, b in enumerate(bins):
        off = 0
        for j, (row, ln) in enumerate(b["members"]):
            tokens[i, off: off + ln] = tb.tokens[row, :ln]
            loss_mask[i, off: off + ln] = tb.loss_mask[row, :ln]
            seg_starts[i, j] = off
            answer_pos[i, j] = off + int(tb.answer_pos[row])
            sample_rows[i, j] = row
            off += ln
        n_segs[i] = len(b["members"])
    return PackedBatch(tokens=tokens, loss_mask=loss_mask, seg_starts=seg_starts,
                       answer_pos=answer_pos, n_segs=n_segs, sample_rows=sample_rows)


@dataclasses.dataclass
class FoldPacked:
    """Per-fold packed train splits, padded to a shared row count so the
    fold-parallel trainer gathers from one stacked array."""

    tokens: np.ndarray  # int32 [k, Np, L]
    loss_mask: np.ndarray  # float32 [k, Np, L]
    seg_starts: np.ndarray  # int32 [k, Np, MAX_SEGS]
    answer_pos: np.ndarray  # int32 [k, Np, MAX_SEGS]
    n_segs: np.ndarray  # int32 [k, Np] (0 on padding rows)
    n_rows: np.ndarray  # int32 [k] real packed rows per fold
    pack_len: int
    #: real sample tokens / (real packed rows × pack_len)
    fill_fraction: float = 0.0

    @property
    def k(self) -> int:
        return self.tokens.shape[0]


def padding_seg_row() -> np.ndarray:
    """The starts of a padding row: one (empty) segment at 0."""
    row = np.full(MAX_SEGS, SEG_PAD, np.int32)
    row[0] = 0
    return row


def pack_fold_datasets(tb: TokenBatch, fold_id: np.ndarray, k: int, pack_len: int,
                       include_mask: Optional[np.ndarray] = None) -> FoldPacked:
    """Pack each fold's train split (``fold_id != f``, optionally restricted
    by ``include_mask``) into its own rows, padded to the largest per-fold
    row count. Padding rows are all pad tokens with n_segs 0, a zero loss
    mask and one segment at 0; index streams never draw them."""
    keep = np.ones(tb.n, bool) if include_mask is None else np.asarray(include_mask, bool)
    train_rows = [np.flatnonzero((fold_id != f) & keep) for f in range(k)]
    packs = [pack_rows(tb, r, pack_len) for r in train_rows]
    np_max = max(p.n_rows for p in packs)
    real_tokens = sum(int(tb.lengths[r].sum()) for r in train_rows)
    row_tokens = sum(p.n_rows for p in packs) * pack_len

    def pad_to(a, fill):
        out = np.full((np_max,) + a.shape[1:], fill, a.dtype)
        out[: a.shape[0]] = a
        return out

    seg_pad_row = padding_seg_row()
    return FoldPacked(
        tokens=np.stack([pad_to(p.tokens, tb.pad_id) for p in packs]),
        loss_mask=np.stack([pad_to(p.loss_mask, 0.0) for p in packs]),
        seg_starts=np.stack([
            np.concatenate([p.seg_starts, np.tile(seg_pad_row, (np_max - p.n_rows, 1))])
            for p in packs]),
        answer_pos=np.stack([pad_to(p.answer_pos, -1) for p in packs]),
        n_segs=np.stack([pad_to(p.n_segs, 0) for p in packs]),
        n_rows=np.array([p.n_rows for p in packs], np.int32),
        pack_len=pack_len,
        fill_fraction=real_tokens / row_tokens if row_tokens else 0.0,
    )


def make_packed_fold_batches(n_rows: np.ndarray, batch_size: int, epochs: int, seed: int,
                             batch_multiple: int = 1) -> np.ndarray:
    """Per-fold epoch index streams over packed rows: int32 [steps, k, B].
    Every fold runs the step count of the fold with the most rows; folds
    with fewer wrap around with a fresh permutation per wrap."""
    b = batch_size + (-batch_size) % batch_multiple
    rng = np.random.default_rng(seed)
    if (np.asarray(n_rows) <= 0).any():
        raise ValueError(f"every fold needs >=1 packed row, got {n_rows}")
    steps_per_epoch = max(int(np.ceil(int(r) / b)) for r in n_rows)
    total = steps_per_epoch * epochs
    out = np.zeros((total, len(n_rows), b), np.int32)
    for f, nr in enumerate(np.asarray(n_rows)):
        stream: List[int] = []
        while len(stream) < total * b:
            stream.extend(rng.permutation(int(nr)).tolist())
        out[:, f, :] = np.asarray(stream[: total * b], np.int32).reshape(total, b)
    return out
