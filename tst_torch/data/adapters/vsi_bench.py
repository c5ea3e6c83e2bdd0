# The port's own copy of tst/data/adapters/vsi_bench.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""VSI-Bench adapter (reference README.md:14 — hf.co/datasets/nyu-visionx/VSI-Bench).

VSI-Bench (from "Thinking in Space", reference README.md:60) is a video
spatial-intelligence benchmark with two answer modes the diagnostic must
handle separately (SURVEY.md §2b B1):

  * multiple-choice (MCA) question types — e.g. relative direction/distance,
    appearance order, route planning — scored by exact letter match;
  * numerical-answer (NA) question types — e.g. object counting, absolute
    distance, room size — scored by Mean Relative Accuracy (MRA).

Blind extraction keeps question + options + question-type; the video is
dropped entirely (reference README.md:35).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from tst_torch.data.adapters._hf import first_present, load_rows
from tst_torch.data.schema import (MCQ, NUMERIC, OPTION_LETTERS, BlindDataset,
                             Sample, resolve_gold_letter)

HUB_ID = "nyu-visionx/VSI-Bench"

#: Question types with numeric (NA) answers, per the released dataset schema.
NUMERIC_TYPES = {
    "object_counting",
    "object_abs_distance",
    "object_size_estimation",
    "room_size_estimation",
}


def row_to_sample(row: dict, idx: int) -> Optional[Sample]:
    qtype = str(first_present(row, "question_type", "type", default="unknown"))
    question = str(first_present(row, "question", default="")).strip()
    if not question:
        return None
    options = first_present(row, "options", "choices", default=None)
    gt = first_present(row, "ground_truth", "answer", "gt", default=None)
    if gt is None:
        return None
    sid = str(first_present(row, "id", "index", default=idx))
    meta = {
        "question_type": qtype,
        "scene_name": first_present(row, "scene_name", default=None),
        "dataset": first_present(row, "dataset", default=None),
    }
    is_numeric = qtype in NUMERIC_TYPES or not options
    if is_numeric:
        try:
            value = float(str(gt).strip())
        except ValueError:
            return None
        return Sample(
            id=f"vsi-{sid}",
            question=question,
            options=[],
            answer=f"{value:g}",
            answer_type=NUMERIC,
            category=qtype,
            meta=meta,
        )
    opts = [_strip_letter_prefix(str(o)) for o in options]
    answer = resolve_gold_letter(gt, opts)
    if answer is None:
        return None
    return Sample(
        id=f"vsi-{sid}",
        question=question,
        options=opts,
        answer=answer,
        answer_type=MCQ,
        category=qtype,
        meta=meta,
    )


def _strip_letter_prefix(opt: str) -> str:
    o = opt.strip()
    if len(o) >= 2 and o[0].upper() in OPTION_LETTERS and o[1] in ".):":
        return o[2:].strip()
    return o


def rows_to_samples(rows: Iterable[dict]) -> List[Sample]:
    out = []
    for i, row in enumerate(rows):
        s = row_to_sample(row, i)
        if s is not None:
            out.append(s)
    return out


def load(source=HUB_ID, split: str = "test", **kw) -> BlindDataset:
    rows = load_rows(source, split=split, **kw)
    return BlindDataset("vsi_bench", rows_to_samples(rows))
