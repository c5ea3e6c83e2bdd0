"""Hand-crafted text features for the RF auditor (counterpart of
``tst/features/featurize.py``).

Two stages, as in the reference:

  1. host extraction (``_raw_counts``, a copy of the reference's): text →
     padded numeric arrays (char/word counts, token-overlap counts, parsed
     numeric values);
  2. device derivation (``_derive_features``, jit'd jnp in the reference):
     the rank / extreme / z-score / one-hot math over those arrays, here in
     torch on the run's device in f32, with the same operations in the same
     order.

Every column has a stable name in ``FeatureMatrix.names`` so the forest's
feature importances read as text.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from tst_torch.data.schema import MCQ, BlindDataset

_WORD_RE = re.compile(r"[a-z0-9']+")
_NUM_RE = re.compile(r"-?\d+(?:\.\d+)?")

#: Tell-tale option phrasings that correlate with gold answers in the wild.
_SPECIAL_PHRASES = ("all of the above", "none of the above", "both", "cannot be determined")


@dataclasses.dataclass
class FeatureMatrix:
    x: np.ndarray  # float32 [N, D]
    names: List[str]  # length D
    labels: np.ndarray  # int32 [N] gold option index (-1 non-MCQ)
    n_options: np.ndarray  # int32 [N]
    categories: List[str]  # category vocabulary used for one-hots

    @property
    def n(self) -> int:
        return self.x.shape[0]

    @property
    def dim(self) -> int:
        return self.x.shape[1]


def _words(text: str) -> List[str]:
    return _WORD_RE.findall(text.lower())


def _parse_number(opt: str) -> float:
    m = _NUM_RE.search(opt.replace(",", ""))
    return float(m.group()) if m else np.nan


def _raw_counts(ds: BlindDataset, max_opts: int, categories: Sequence[str]):
    """Host pass: text → numeric arrays. Returns dict of np arrays."""
    n = len(ds)
    q_chars = np.zeros(n, np.float32)
    q_words = np.zeros(n, np.float32)
    ctx_chars = np.zeros(n, np.float32)
    n_opts = np.zeros(n, np.int32)
    cat_id = np.zeros(n, np.int32)
    opt_chars = np.zeros((n, max_opts), np.float32)
    opt_words = np.zeros((n, max_opts), np.float32)
    opt_q_overlap = np.zeros((n, max_opts), np.float32)  # |opt∩q| / |opt|
    opt_o_overlap = np.zeros((n, max_opts), np.float32)  # mean overlap w/ other opts
    opt_numeric = np.full((n, max_opts), np.nan, np.float32)
    opt_special = np.zeros((n, max_opts), np.float32)
    cat_index = {c: i for i, c in enumerate(categories)}
    for i, s in enumerate(ds):
        qw = set(_words(s.question))
        q_chars[i] = len(s.question)
        q_words[i] = len(_words(s.question))
        ctx_chars[i] = len(s.context)
        cat_id[i] = cat_index.get(s.category, len(categories))
        if s.answer_type != MCQ:
            continue
        k = len(s.options)
        n_opts[i] = k
        ow = [set(_words(o)) for o in s.options]
        for j, o in enumerate(s.options):
            opt_chars[i, j] = len(o)
            opt_words[i, j] = len(ow[j])
            if ow[j]:
                opt_q_overlap[i, j] = len(ow[j] & qw) / len(ow[j])
                others = [len(ow[j] & ow[m]) / len(ow[j]) for m in range(k) if m != j]
                opt_o_overlap[i, j] = float(np.mean(others)) if others else 0.0
            opt_numeric[i, j] = _parse_number(o)
            lo = o.lower()
            opt_special[i, j] = float(any(p in lo for p in _SPECIAL_PHRASES))
    return dict(
        q_chars=q_chars, q_words=q_words, ctx_chars=ctx_chars, n_opts=n_opts,
        cat_id=cat_id, opt_chars=opt_chars, opt_words=opt_words,
        opt_q_overlap=opt_q_overlap, opt_o_overlap=opt_o_overlap,
        opt_numeric=opt_numeric, opt_special=opt_special,
    )


def _derive_features(raw: Dict[str, torch.Tensor], max_opts: int, n_cats: int) -> torch.Tensor:
    """Device pass: rank / extreme / z-score / one-hot feature math, f32."""
    f32 = torch.float32
    k = raw["n_opts"].to(f32)  # [N]
    valid = (torch.arange(max_opts, device=k.device)[None, :]
             < raw["n_opts"][:, None])  # [N, max_opts]
    safe_k = torch.clamp(k, min=1.0)

    def masked(a, fill):
        return torch.where(valid, a, torch.as_tensor(fill, dtype=a.dtype, device=a.device))

    oc = masked(raw["opt_chars"], 0.0)
    mean_len = oc.sum(-1) / safe_k
    std_len = torch.sqrt(masked((oc - mean_len[:, None]) ** 2, 0.0).sum(-1) / safe_k)
    rel_len = torch.where(valid, oc / torch.clamp(mean_len[:, None], min=1.0),
                          torch.zeros((), dtype=f32, device=k.device))
    neg_inf, pos_inf = -1e9, 1e9
    is_longest = valid & (oc >= masked(oc, neg_inf).amax(-1, keepdim=True))
    is_shortest = valid & (oc <= masked(oc, pos_inf).amin(-1, keepdim=True))
    # length rank in [0,1]: fraction of valid options strictly shorter
    shorter = (oc[:, None, :] < oc[:, :, None]) & valid[:, None, :] & valid[:, :, None]
    len_rank = masked(shorter.sum(-1).to(f32) / safe_k[:, None], 0.0)

    num = raw["opt_numeric"]
    is_num = valid & ~torch.isnan(num)
    num0 = torch.where(is_num, num, torch.zeros((), dtype=f32, device=k.device))
    n_num = torch.clamp(is_num.sum(-1).to(f32), min=1.0)
    num_mean = num0.sum(-1) / n_num
    num_std = torch.sqrt(torch.where(is_num, (num0 - num_mean[:, None]) ** 2,
                                     torch.zeros((), dtype=f32, device=k.device)).sum(-1)
                         / n_num)
    num_z = torch.where(is_num, (num0 - num_mean[:, None])
                        / torch.clamp(num_std[:, None], min=1e-6),
                        torch.zeros((), dtype=f32, device=k.device))
    num_max = torch.where(is_num, num, torch.full((), neg_inf, device=k.device)).amax(
        -1, keepdim=True)
    num_min = torch.where(is_num, num, torch.full((), pos_inf, device=k.device)).amin(
        -1, keepdim=True)
    is_num_max = is_num & (num0 >= num_max)
    is_num_min = is_num & (num0 <= num_min)
    # "middle value" prior: neither min nor max among >=3 numeric options
    is_num_mid = is_num & ~is_num_max & ~is_num_min & (is_num.sum(-1, keepdim=True) >= 3)

    cat_onehot = torch.nn.functional.one_hot(raw["cat_id"].long(), n_cats + 1).to(f32)

    global_feats = [
        torch.log1p(raw["q_chars"]),
        torch.log1p(raw["q_words"]),
        torch.log1p(raw["ctx_chars"]),
        k,
        torch.log1p(mean_len),
        std_len / torch.clamp(mean_len, min=1.0),
    ]
    per_slot = [
        rel_len,
        len_rank,
        is_longest.to(f32),
        is_shortest.to(f32),
        masked(raw["opt_words"], 0.0),
        masked(raw["opt_q_overlap"], 0.0),
        masked(raw["opt_o_overlap"], 0.0),
        num_z,
        is_num_max.to(f32),
        is_num_min.to(f32),
        is_num_mid.to(f32),
        masked(raw["opt_special"], 0.0),
        valid.to(f32),
    ]
    return torch.cat([torch.stack(global_feats, -1)] + per_slot + [cat_onehot], dim=-1).to(f32)


_GLOBAL_NAMES = ["q_chars_log", "q_words_log", "ctx_chars_log", "n_options",
                 "opt_len_mean_log", "opt_len_cv"]
_SLOT_NAMES = ["rel_len", "len_rank", "is_longest", "is_shortest", "opt_words",
               "q_overlap", "opt_overlap", "num_z", "is_num_max", "is_num_min",
               "is_num_mid", "special_phrase", "slot_valid"]


def featurize(
    ds: BlindDataset,
    *,
    device: torch.device,
    categories: Optional[Sequence[str]] = None,
    max_opts: Optional[int] = None,
) -> FeatureMatrix:
    """Dataset → named feature matrix + gold labels for the RF auditor; the
    derivation runs on ``device``.

    ``categories``/``max_opts`` pin the output schema so train/heldout folds
    (and IBP rounds over shrinking subsets) produce identical columns.
    """
    cats = list(categories) if categories is not None else ds.categories
    mo = max_opts or max((len(s.options) for s in ds), default=1)
    mo = max(mo, 1)
    raw = _raw_counts(ds, mo, cats)
    x = _derive_features({key: torch.from_numpy(v).to(device) for key, v in raw.items()},
                         mo, len(cats)).cpu().numpy()
    names = list(_GLOBAL_NAMES)
    for fam in _SLOT_NAMES:
        names += [f"{fam}[{c}]" for c in range(mo)]
    names += [f"cat={c}" for c in cats] + ["cat=<other>"]
    assert len(names) == x.shape[1], (len(names), x.shape)
    labels = np.array([s.answer_index for s in ds], dtype=np.int32)
    n_options = np.array(
        [len(s.options) if s.answer_type == MCQ else 0 for s in ds], dtype=np.int32
    )
    return FeatureMatrix(x=x, names=names, labels=labels, n_options=n_options, categories=cats)
