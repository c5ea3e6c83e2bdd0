# The port's own copy of tst/data/adapters/mmmu.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""MMMU adapter (reference README.md:35).

Multi-discipline college-level benchmark; rows carry up to 7 images referenced
inline as "<image N>" plus MCQ options (stored as a Python-literal string) or
open answers. Blind extraction keeps the text with image placeholders intact
(they are themselves a documented shortcut channel: option/question text often
gives the answer away without the image). MMMU is the k=5-fold Llama-3-8B
fold-parallel workload (BASELINE.json config 3).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional

from tst_torch.data.adapters._hf import first_present, load_rows
from tst_torch.data.schema import (MCQ, OPEN, OPTION_LETTERS, BlindDataset, Sample,
                             resolve_gold_letter)

HUB_ID = "MMMU/MMMU"


def _parse_options(raw) -> List[str]:
    if raw is None:
        return []
    if isinstance(raw, (list, tuple)):
        return [str(o).strip() for o in raw]
    s = str(raw).strip()
    if not s or s == "[]":
        return []
    try:
        val = ast.literal_eval(s)
        if isinstance(val, (list, tuple)):
            return [str(o).strip() for o in val]
    except (ValueError, SyntaxError):
        pass
    return [s]


def row_to_sample(row: dict, idx: int) -> Optional[Sample]:
    question = str(first_present(row, "question", default="")).strip()
    if not question:
        return None
    sid = str(first_present(row, "id", default=idx))
    qtype = str(first_present(row, "question_type", default="multiple-choice"))
    answer = first_present(row, "answer", default=None)
    if answer is None:
        return None
    category = str(
        first_present(row, "subfield", "subject", default=sid.split("_")[1] if "_" in sid else "unknown")
    )
    meta = {
        "topic_difficulty": first_present(row, "topic_difficulty", default=None),
        "question_type": qtype,
        "img_type": first_present(row, "img_type", default=None),
    }
    options = _parse_options(first_present(row, "options", default=None))
    if qtype == "multiple-choice" and options:
        a = resolve_gold_letter(answer, options)
        if a is None:
            return None
        return Sample(
            id=f"mmmu-{sid}",
            question=question,
            options=options,
            answer=a,
            answer_type=MCQ,
            category=category,
            meta=meta,
        )
    return Sample(
        id=f"mmmu-{sid}",
        question=question,
        options=[],
        answer=str(answer).strip(),
        answer_type=OPEN,
        category=category,
        meta=meta,
    )


def rows_to_samples(rows: Iterable[dict], mcq_only: bool = False) -> List[Sample]:
    out = []
    for i, row in enumerate(rows):
        s = row_to_sample(row, i)
        if s is None:
            continue
        if mcq_only and s.answer_type != MCQ:
            continue
        out.append(s)
    return out


def load(source=HUB_ID, split: str = "validation", mcq_only: bool = True, **kw) -> BlindDataset:
    rows = load_rows(source, split=split, **kw)
    return BlindDataset("mmmu", rows_to_samples(rows, mcq_only=mcq_only))
