# The port's own copy of tst/data/adapters/video_mme.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Video-MME adapter (reference README.md:35).

4-option video MCQs; options arrive pre-lettered ("A. ..."). The blind input
optionally includes the subtitle transcript — the long-sequence workload of
BASELINE.json config 4 (SURVEY.md §5 long-context: transcripts reach tens of
thousands of tokens, exercising flash-attention streaming / ring attention).
The video itself is always dropped (reference README.md:35).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from tst_torch.data.adapters._hf import first_present, load_rows
from tst_torch.data.schema import (MCQ, OPTION_LETTERS, BlindDataset, Sample,
                             resolve_gold_letter)

HUB_ID = "lmms-lab/Video-MME"


def _strip_letter_prefix(opt: str) -> str:
    o = str(opt).strip()
    if len(o) >= 2 and o[0].upper() in OPTION_LETTERS and o[1] in ".):":
        return o[2:].strip()
    return o


def row_to_sample(row: dict, idx: int, include_subtitles: bool = True) -> Optional[Sample]:
    question = str(first_present(row, "question", default="")).strip()
    options = first_present(row, "options", "choices", default=None)
    answer = first_present(row, "answer", default=None)
    if not question or not options or answer is None:
        return None
    sid = str(first_present(row, "question_id", "id", default=idx))
    subtitle = ""
    if include_subtitles:
        subtitle = str(first_present(row, "subtitle", "subtitles", "transcript", default="") or "")
    opts = [_strip_letter_prefix(o) for o in options]
    a = resolve_gold_letter(answer, opts)
    if a is None:
        return None
    return Sample(
        id=f"vmme-{sid}",
        question=question,
        options=opts,
        answer=a,
        answer_type=MCQ,
        category=str(first_present(row, "task_type", "sub_category", default="unknown")),
        context=subtitle,
        meta={
            "duration": first_present(row, "duration", default=None),
            "domain": first_present(row, "domain", default=None),
            "video_id": first_present(row, "video_id", "videoID", default=None),
        },
    )


def rows_to_samples(rows: Iterable[dict], include_subtitles: bool = True) -> List[Sample]:
    out = []
    for i, row in enumerate(rows):
        s = row_to_sample(row, i, include_subtitles)
        if s is not None:
            out.append(s)
    return out


def load(source=HUB_ID, split: str = "test", include_subtitles: bool = True, **kw) -> BlindDataset:
    rows = load_rows(source, split=split, **kw)
    return BlindDataset("video_mme", rows_to_samples(rows, include_subtitles))
