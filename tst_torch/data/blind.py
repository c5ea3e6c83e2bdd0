# The port's own copy of tst/data/blind.py: the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Blind-prompt rendering: Sample → text the LLM sees.

The diagnostic's defining constraint is that the model receives *only* the
non-visual, textual inputs of each test sample (reference README.md:35). This
module renders those inputs into a deterministic chat-free prompt whose answer
is a single token (the option letter) for MCQ samples, so held-out scoring can
read per-option probabilities from one forward pass (SURVEY.md §3.1 hot loop 2).
"""

from __future__ import annotations

from typing import Tuple

from tst_torch.data.schema import MCQ, NUMERIC, OPTION_LETTERS, Sample

#: Marks where the answer begins. The target text follows this marker; the SFT
#: loss is masked to target tokens only (prompt-masked labels, SURVEY.md §2b B7).
ANSWER_MARKER = "Answer:"

_MCQ_INSTRUCTION = (
    "Select the best answer to the following multiple-choice question. "
    "Respond with only the letter of the correct option.\n"
)
_NUMERIC_INSTRUCTION = (
    "Answer the following question with a single number. "
    "Respond with only the number.\n"
)
_OPEN_INSTRUCTION = "Answer the following question concisely.\n"

_MAX_CONTEXT_CHARS = 120_000  # keep pathological transcripts bounded


def render_prompt(sample: Sample, include_context: bool = True) -> str:
    """Render the blind input up to and including ``ANSWER_MARKER``.

    The gold answer is *not* included — callers append it (training) or score
    continuations against it (inference).
    """
    parts = []
    if sample.answer_type == MCQ:
        parts.append(_MCQ_INSTRUCTION)
    elif sample.answer_type == NUMERIC:
        parts.append(_NUMERIC_INSTRUCTION)
    else:
        parts.append(_OPEN_INSTRUCTION)
    if include_context and sample.context:
        ctx = sample.context[:_MAX_CONTEXT_CHARS]
        parts.append(f"Context:\n{ctx}\n\n")
    parts.append(f"Question: {sample.question.strip()}\n")
    if sample.answer_type == MCQ:
        for letter, opt in zip(OPTION_LETTERS, sample.options):
            parts.append(f"{letter}. {opt.strip()}\n")
    parts.append(ANSWER_MARKER)
    return "".join(parts)


def render_target(sample: Sample) -> str:
    """The supervised target text (leading space + answer)."""
    return " " + sample.answer.strip()


def render_example(sample: Sample, include_context: bool = True) -> Tuple[str, str]:
    """(prompt, target) pair for SFT."""
    return render_prompt(sample, include_context), render_target(sample)
