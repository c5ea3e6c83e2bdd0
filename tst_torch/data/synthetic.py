# The port's own copy of tst/data/synthetic.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Synthetic benchmarks with *planted* non-visual shortcuts.

The reference's central claim is that benchmarks can be "aced ... without
strong visual understanding" because of "exploitable non-visual shortcuts"
(reference README.md:33). To test that our diagnostic actually detects such
shortcuts (not merely that the plumbing runs), we generate benchmarks where a
known fraction of samples carries a controllable bias, e.g. the gold answer is
always the longest option. The integration contract (SURVEY.md §4.4):

  * on a planted-bias benchmark, blind k-fold accuracy must rise well above
    chance and s(x) must rank biased samples first;
  * on the unbiased control, blind accuracy must stay near chance;
  * IBP must prune the planted-bias samples before the clean ones.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from tst_torch.data.schema import MCQ, NUMERIC, OPEN, BlindDataset, OPTION_LETTERS, Sample

_NOUNS = [
    "chair", "table", "sofa", "lamp", "window", "door", "shelf", "rug",
    "plant", "monitor", "cabinet", "stool", "mirror", "curtain", "bin",
]
_ADJS = ["red", "blue", "large", "small", "wooden", "metal", "round", "square"]
_CATEGORIES = ["object_count", "relative_distance", "room_size", "route_plan"]


def _rand_phrase(rng: np.random.Generator, n_words: int) -> str:
    words = []
    for _ in range(n_words):
        pool = _ADJS if rng.random() < 0.4 else _NOUNS
        words.append(pool[int(rng.integers(len(pool)))])
    return " ".join(words)


def make_synthetic_mcq(
    n: int = 256,
    n_options: int = 4,
    bias_fraction: float = 0.0,
    bias_kind: str = "longest_option",
    seed: int = 0,
    name: Optional[str] = None,
) -> BlindDataset:
    """Generate an MCQ benchmark with a planted shortcut on a known subset.

    ``bias_kind``:
      * ``longest_option`` — on biased samples the gold option is padded to be
        clearly the longest (a classic length prior).
      * ``position`` — the gold answer of biased samples is always letter "A"
        (answer-position prior; unbiased samples get a uniform position).
      * ``keyword`` — biased samples embed a tell-tale token from the gold
        option inside the question (option-overlap shortcut).

    Sample ``meta["planted_bias"]`` records ground truth for tests.
    """
    rng = np.random.default_rng(seed)
    n_biased = int(round(n * bias_fraction))
    samples: List[Sample] = []
    for i in range(n):
        biased = i < n_biased
        category = _CATEGORIES[int(rng.integers(len(_CATEGORIES)))]
        question = (
            f"How would you describe the {_rand_phrase(rng, 2)} near the "
            f"{_rand_phrase(rng, 1)} in the scene?"
        )
        options = [_rand_phrase(rng, int(rng.integers(2, 5))) for _ in range(n_options)]
        if biased and bias_kind == "position":
            gold = 0
        else:
            gold = int(rng.integers(n_options))
        if biased:
            if bias_kind == "longest_option":
                options[gold] = options[gold] + " " + _rand_phrase(rng, 6)
            elif bias_kind == "keyword":
                tell = options[gold].split()[0]
                question = question[:-1] + f" regarding the {tell}?"
            elif bias_kind == "position":
                pass
            else:
                raise ValueError(f"unknown bias_kind {bias_kind!r}")
        samples.append(
            Sample(
                id=f"syn-{seed}-{i:05d}",
                question=question,
                options=options,
                answer=OPTION_LETTERS[gold],
                answer_type=MCQ,
                category=category,
                meta={"planted_bias": bool(biased), "bias_kind": bias_kind if biased else None},
            )
        )
    # Shuffle so biased samples are not a contiguous prefix (fold splits and
    # prune tests must not be able to cheat on index order).
    order = rng.permutation(n)
    samples = [samples[j] for j in order]
    return BlindDataset(name or f"synthetic_mcq_b{bias_fraction:g}_{bias_kind}", samples)


def make_synthetic_open(
    n: int = 128,
    bias_fraction: float = 0.0,
    seed: int = 0,
) -> BlindDataset:
    """Open-answer benchmark with a planted answer-prior shortcut.

    Biased samples always have the same gold answer ("red" — a marginal
    answer prior a blind model trained on the other folds reproduces);
    unbiased samples draw a uniform random answer word. Exercises the
    free-form decode → normalized-exact-match s(x) path (MMMU's open split,
    reference README.md:35).
    """
    rng = np.random.default_rng(seed)
    n_biased = int(round(n * bias_fraction))
    samples: List[Sample] = []
    for i in range(n):
        biased = i < n_biased
        answer = "red" if biased else _NOUNS[int(rng.integers(len(_NOUNS)))]
        samples.append(
            Sample(
                id=f"syn-open-{seed}-{i:05d}",
                question=(
                    f"What is the most salient item near the "
                    f"{_rand_phrase(rng, 2)} in the scene?"
                ),
                options=[],
                answer=answer,
                answer_type=OPEN,
                category=_CATEGORIES[int(rng.integers(len(_CATEGORIES)))],
                meta={"planted_bias": bool(biased)},
            )
        )
    order = rng.permutation(n)
    samples = [samples[j] for j in order]
    return BlindDataset(f"synthetic_open_b{bias_fraction:g}", samples)


def make_synthetic_numeric(n: int = 128, bias_fraction: float = 0.0,
                           seed: int = 0) -> BlindDataset:
    """Numeric-answer benchmark (exercises the VSI-Bench numeric/MRA path).

    ``bias_fraction`` of the rows share one constant gold value — the
    answer-prior shortcut a blind model reproduces (the numeric analogue of
    the MCQ constant-letter bias): a blind SFT learns to emit the constant
    and scores near-perfect MRA on exactly those rows, so IBP must prune
    them (VERDICT r3 missing #3: numeric-only debiasing used to be a silent
    no-op)."""
    rng = np.random.default_rng(seed)
    n_biased = int(round(n * bias_fraction))
    samples = []
    for i in range(n):
        if i < n_biased:
            value = 12.0  # the planted constant-answer prior
        else:
            value = float(np.round(rng.uniform(0.5, 30.0), 1))
        samples.append(
            Sample(
                id=f"syn-num-{seed}-{i:05d}",
                question=(
                    f"What is the size in square meters of the room containing "
                    f"the {_rand_phrase(rng, 2)}?"
                ),
                options=[],
                answer=f"{value:g}",
                answer_type=NUMERIC,
                category="room_size_estimation",
            )
        )
    return BlindDataset("synthetic_numeric", samples)


def make_synthetic_vsi(
    n: int = 5000,
    bias_fraction: float = 0.4,
    numeric_fraction: float = 0.25,
    bias_kind: str = "longest_option",
    seed: int = 0,
) -> BlindDataset:
    """VSI-Bench-SHAPED benchmark: the north-star wall-clock anchor workload
    (BASELINE.json: "k=5 Llama-3-8B blind stress-test of VSI-Bench", ~5k
    samples, mixed MCQ + numeric in VSI's ~3:1 proportion — VERDICT r2
    missing #2: nothing demonstrated the pipeline at VSI sample count).

    MCQ rows carry the standard planted shortcut on ``bias_fraction`` of
    them; biased numeric rows share a constant gold value (an answer prior a
    blind model reproduces), unbiased ones draw uniformly.
    """
    rng = np.random.default_rng(seed)
    n_numeric = int(round(n * numeric_fraction))
    mcq = make_synthetic_mcq(n=n - n_numeric, bias_fraction=bias_fraction,
                             bias_kind=bias_kind, seed=seed)
    samples: List[Sample] = list(mcq.samples)
    n_num_biased = int(round(n_numeric * bias_fraction))
    for i in range(n_numeric):
        biased = i < n_num_biased
        value = 10.0 if biased else float(np.round(rng.uniform(0.5, 30.0), 1))
        samples.append(
            Sample(
                id=f"syn-vsi-num-{seed}-{i:05d}",
                question=(
                    f"What is the size in square meters of the room "
                    f"containing the {_rand_phrase(rng, 2)}?"
                ),
                options=[],
                answer=f"{value:g}",
                answer_type=NUMERIC,
                category="room_size_estimation",
                meta={"planted_bias": bool(biased)},
            )
        )
    order = rng.permutation(len(samples))
    samples = [samples[j] for j in order]
    return BlindDataset(f"synthetic_vsi_b{bias_fraction:g}", samples)
