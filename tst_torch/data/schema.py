# The port's own copy of tst/data/schema.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Canonical sample schema for blind (text-only) benchmark stress-testing.

Requirement: the diagnostic fine-tunes on "exclusively the non-visual, textual
inputs of the test set" (reference README.md:35). Every benchmark adapter
(VSI-Bench, CV-Bench, MMMU, VideoMME — reference README.md:35) normalizes its
rows into :class:`Sample`; everything downstream (featurizer, SFT engine, RF
auditor, IBP) consumes only this schema and never touches images/videos.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence

MCQ = "mcq"
NUMERIC = "numeric"
OPEN = "open"

ANSWER_TYPES = (MCQ, NUMERIC, OPEN)

#: Option letters used for MCQ rendering and answer normalization. Ten slots
#: covers every benchmark in scope (VideoMME/CV-Bench: 4, VSI-Bench MCQ: 4,
#: MMMU: up to 9 observed).
OPTION_LETTERS = tuple("ABCDEFGHIJ")
MAX_OPTIONS = len(OPTION_LETTERS)


@dataclasses.dataclass
class Sample:
    """One benchmark sample, reduced to its non-visual textual content."""

    id: str
    question: str
    options: List[str]  # empty for numeric / open questions
    answer: str  # MCQ: canonical letter "A".."J"; numeric: decimal string
    answer_type: str = MCQ
    category: str = "default"
    #: Extra text channels that belong to the *blind* input (e.g. VideoMME
    #: subtitle transcripts). Never image/video payloads.
    context: str = ""
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.answer_type not in ANSWER_TYPES:
            raise ValueError(f"bad answer_type {self.answer_type!r}")
        if self.answer_type == MCQ:
            if not self.options:
                raise ValueError(f"MCQ sample {self.id} has no options")
            if len(self.options) > MAX_OPTIONS:
                raise ValueError(
                    f"sample {self.id}: {len(self.options)} options > {MAX_OPTIONS}"
                )
            self.answer = normalize_letter(self.answer, len(self.options))

    @property
    def answer_index(self) -> int:
        """MCQ gold option index; -1 for non-MCQ."""
        if self.answer_type != MCQ:
            return -1
        return OPTION_LETTERS.index(self.answer)

    @property
    def answer_value(self) -> float:
        """Numeric gold value; NaN when not numeric."""
        if self.answer_type != NUMERIC:
            return float("nan")
        return float(self.answer)

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "Sample":
        return cls(**d)


def resolve_gold_letter(answer, options) -> Optional[str]:
    """Resolve a raw gold answer (letter OR full option text) to a letter.

    Order matters: exact option-text match takes priority, otherwise answers
    like "Bird" would be misparsed as letter "B" (pointing at a different
    option). Returns None when the answer is neither an option text nor a
    recognizable letter — callers should skip the row rather than guess.
    """
    import re

    a = str(answer).strip()
    if not a:
        return None
    opts = [str(o).strip().lower() for o in options]
    if a.lower() in opts:
        return OPTION_LETTERS[opts.index(a.lower())]
    m = re.fullmatch(r"[\(\[]?([A-Ja-j])[\)\]\.:]?", a)
    if m and m.group(1).upper() in OPTION_LETTERS[: len(options)]:
        return m.group(1).upper()
    # "B) some text" / "B. text" style: letter + separator + anything
    m = re.match(r"^[\(\[]?([A-Ja-j])[\)\]\.:]\s", a)
    if m and m.group(1).upper() in OPTION_LETTERS[: len(options)]:
        return m.group(1).upper()
    return None


def normalize_letter(answer: str, n_options: int) -> str:
    """Normalize an MCQ gold answer to a bare letter.

    Accepts "B", "b", "(B)", "B.", "B) some text", or the full option text
    (resolved by the adapter before calling). Mirrors the answer-extraction
    robustness the paper's evaluation needs (reference README.md:35 "reveal
    shortcut performance").
    """
    a = str(answer).strip()
    if not a:
        raise ValueError("empty MCQ answer")
    a = a.strip("()[].: ").strip()
    letter = a[:1].upper()
    if letter not in OPTION_LETTERS[:n_options]:
        raise ValueError(f"cannot normalize MCQ answer {answer!r} ({n_options} options)")
    return letter


class BlindDataset:
    """An ordered, immutable collection of :class:`Sample` plus benchmark metadata.

    The single handoff type between data adapters and the diagnostic stack
    (SURVEY.md §2b B5). Deterministic order: adapters must sort or preserve
    upstream order so fold splits are reproducible.
    """

    def __init__(self, name: str, samples: Sequence[Sample]):
        self.name = name
        self.samples: List[Sample] = list(samples)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, i: int) -> Sample:
        return self.samples[i]

    def __iter__(self):
        return iter(self.samples)

    @property
    def categories(self) -> List[str]:
        return sorted({s.category for s in self.samples})

    def subset(self, indices: Iterable[int]) -> "BlindDataset":
        idx = list(indices)
        return BlindDataset(self.name, [self.samples[i] for i in idx])

    def chance_accuracy(self) -> float:
        """Expected accuracy of uniform random guessing on the MCQ portion.

        The paper's key comparison point: blind accuracy vs. chance
        ("random guessing", reference README.md:33).
        """
        mcq = [s for s in self.samples if s.answer_type == MCQ]
        if not mcq:
            return 0.0
        return sum(1.0 / len(s.options) for s in mcq) / len(mcq)

    def fingerprint(self) -> str:
        """Stable content hash — keys checkpoints and fold splits."""
        h = hashlib.sha256()
        h.update(self.name.encode())
        for s in self.samples:
            h.update(json.dumps(s.to_json(), sort_keys=True).encode())
        return h.hexdigest()[:16]

    def save_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"_benchmark": self.name}) + "\n")
            for s in self.samples:
                f.write(json.dumps(s.to_json()) + "\n")

    @classmethod
    def load_jsonl(cls, path: str) -> "BlindDataset":
        samples: List[Sample] = []
        name = "unknown"
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                d = json.loads(line)
                if "_benchmark" in d:
                    name = d["_benchmark"]
                    continue
                samples.append(Sample.from_json(d))
        return cls(name, samples)
