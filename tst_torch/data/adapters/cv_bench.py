# The port's own copy of tst/data/adapters/cv_bench.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""CV-Bench adapter (reference README.md:35; CV-Bench ships with Cambrian-1,
reference README.md:58).

~2.6k image MCQs over four tasks: 2D Count / Relation and 3D Depth / Distance.
Blind extraction keeps question + choices + task metadata; the image is
dropped (reference README.md:35). This is the benchmark of BASELINE.json
config 1 (CPU Random-Forest parity) and config 2 (Qwen2.5-0.5B 2-fold SFT).
"""

from __future__ import annotations

from typing import Iterable, List, Optional

from tst_torch.data.adapters._hf import first_present, load_rows
from tst_torch.data.schema import MCQ, BlindDataset, Sample, resolve_gold_letter

HUB_ID = "nyu-visionx/CV-Bench"


def row_to_sample(row: dict, idx: int) -> Optional[Sample]:
    question = str(first_present(row, "question", default="")).strip()
    choices = first_present(row, "choices", "options", default=None)
    answer = first_present(row, "answer", "ground_truth", default=None)
    if not question or not choices or answer is None:
        return None
    sid = str(first_present(row, "idx", "id", "index", default=idx))
    task = str(first_present(row, "task", default="unknown"))
    dim = str(first_present(row, "type", default="")).strip()  # "2D" / "3D"
    category = f"{dim}_{task}".strip("_").lower()
    opts = [str(o).strip() for o in choices]
    a = resolve_gold_letter(answer, opts)  # released format: "(A)"
    if a is None:
        return None
    return Sample(
        id=f"cvb-{sid}",
        question=question,
        options=opts,
        answer=a,
        answer_type=MCQ,
        category=category,
        meta={"task": task, "type": dim, "source": first_present(row, "source", default=None)},
    )


def rows_to_samples(rows: Iterable[dict]) -> List[Sample]:
    out = []
    for i, row in enumerate(rows):
        s = row_to_sample(row, i)
        if s is not None:
            out.append(s)
    return out


def load(source=HUB_ID, split: str = "test", **kw) -> BlindDataset:
    rows = load_rows(source, split=split, **kw)
    return BlindDataset("cv_bench", rows_to_samples(rows))
