# The port's own copy of tst/data/tokenize.py (the native C++ packer left out): the port imports nothing of
# tst. tests/test_torch_host.py holds the two to equal results.
"""Tokenization + fixed-shape packing of blind prompts for TPU.

TPU/XLA programs are compiled per shape, so variable-length text must become
statically-shaped int32 arrays (SURVEY.md §7 hard part 5: avoid recompilation
storms via padding buckets). This module turns rendered (prompt, target) pairs
into:

  * ``tokens``     int32 [N, L]  right-padded token ids
  * ``loss_mask``  f32   [N, L]  1.0 on target-token positions (prompt-masked
                                  labels — loss on answer tokens only)
  * ``answer_pos`` int32 [N]     index of the last prompt token; logits at this
                                  position predict the first target token, which
                                  is how MCQ options are scored in ONE forward
                                  pass per sample (SURVEY.md §3.1 hot loop 2)
  * ``gold``       int32 [N]     gold option index (MCQ) or -1

Two tokenizer backends:
  * :class:`ByteTokenizer` — dependency-free byte-level fallback; keeps every
    test and the whole pipeline runnable offline (no HF assets in this env).
  * :class:`HFTokenizer` — wraps a local ``transformers`` tokenizer for real
    Llama-3 / Qwen2.5 runs (models named by BASELINE.json configs).

Both expose ``option_token_ids``: the id of the single token that begins each
option's target text. For HF BPE tokenizers that token is " A"/" B"/...; for
the byte backend the leading space is folded into the prompt instead so the
letter byte itself is the first target token. This invariant is what makes
per-option log-probability scoring a single gather from one forward pass.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from tst_torch.data import blind
from tst_torch.data.schema import MCQ, OPTION_LETTERS, BlindDataset

#: Sequence-length buckets (multiples of 128 for TPU lane alignment). A batch
#: is padded to the smallest bucket >= its longest sequence; the set is small
#: so at most len(BUCKETS) distinct XLA programs are ever compiled per model.
DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)


def pick_bucket(max_len: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if max_len <= b:
            return b
    raise ValueError(f"sequence length {max_len} exceeds largest bucket {buckets[-1]}")


def _resolve_len(lengths, max_len, buckets) -> int:
    """Final padded length: user cap rounded up to a lane multiple (TPU
    kernels tile the sequence in 128-blocks; a non-multiple would drop tail
    rows in the flash-attention grid), else the smallest bucket that fits —
    clamped to the largest bucket (longer samples head-truncate, keeping the
    answerable question/options tail)."""
    if max_len is not None:
        return max_len + (-max_len) % 128
    return pick_bucket(min(int(lengths.max()), buckets[-1]), buckets)


class ByteTokenizer:
    """Byte-level tokenizer: ids 0..255 are raw bytes; specials above.

    Vocab is padded to 384 (3*128) so embedding tables tile cleanly onto the
    TPU lane dimension.
    """

    pad_id = 256
    bos_id = 257
    eos_id = 258
    vocab_size = 384
    name = "byte"
    #: the byte tokenizer emits the leading space of a target as prompt tail,
    #: so the first *target* token is the letter itself.
    _target_space_in_prompt = True

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8", errors="replace"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")

    def encode_example(self, prompt: str, target: str) -> Tuple[List[int], List[int]]:
        if self._target_space_in_prompt and target.startswith(" "):
            prompt = prompt + " "
            target = target[1:]
        p = [self.bos_id] + self.encode(prompt)
        t = self.encode(target) + [self.eos_id]
        return p, t

    def option_token_ids(self, n_options: int) -> np.ndarray:
        return np.array(
            [self.encode(OPTION_LETTERS[i])[0] for i in range(n_options)], dtype=np.int32
        )


class HFTokenizer:
    """Adapter over a local HuggingFace tokenizer (Llama-3 / Qwen2.5).

    ``chat=True`` (``data.prompt_style='chat'``) renders each prompt through
    the tokenizer's chat template as one user turn + generation prompt — the
    format instruct checkpoints were tuned on (VERDICT r2 missing #4: raw
    completion prompts silently depress their blind accuracy). In chat mode
    the answer letter follows the template's assistant header (no leading
    space), so option tokens are the bare-letter encodings; teacher-forced
    token sequences are built from OUR ids (prompt ids + target ids), so
    training/scoring stay self-consistent by construction.
    """

    name = "hf"

    def __init__(self, path_or_tokenizer, chat: bool = False):
        if isinstance(path_or_tokenizer, str):
            from transformers import AutoTokenizer

            self.tok = AutoTokenizer.from_pretrained(path_or_tokenizer, local_files_only=True)
        else:
            self.tok = path_or_tokenizer
        self.chat = bool(chat)
        if self.chat and getattr(self.tok, "chat_template", None) is None:
            raise ValueError(
                "data.prompt_style='chat' needs a tokenizer with a chat "
                "template (this one has none — use 'completion')")
        self.pad_id = self.tok.pad_token_id
        if self.pad_id is None:
            self.pad_id = self.tok.eos_token_id
        self.bos_id = self.tok.bos_token_id
        self.eos_id = self.tok.eos_token_id
        self.vocab_size = len(self.tok)
        # The single-token invariant (" A" completion-style / bare "A" after
        # a chat template's assistant header) enables the fast MCQ scorer
        # (ONE forward per sample, one letter-column gather). Llama-3 and
        # Qwen2.5 satisfy it both ways; a violating tokenizer falls back to
        # multi-token option scoring (sum of per-token log-probs — C
        # forwards per sample) instead of killing the run (VERDICT r2 #6).
        self.single_token_options = all(
            len(self._encode_option(letter)) == 1 for letter in OPTION_LETTERS
        )

    def _encode_option(self, letter: str) -> List[int]:
        text = letter if self.chat else " " + letter
        return self.tok.encode(text, add_special_tokens=False)

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(list(ids))

    def encode_example(self, prompt: str, target: str) -> Tuple[List[int], List[int]]:
        if self.chat:
            p = self.tok.apply_chat_template(
                [{"role": "user", "content": prompt}],
                add_generation_prompt=True, tokenize=True)
            # the assistant turn starts after the template's own separator:
            # the target's leading space becomes the bare answer text
            target = target.lstrip(" ")
        else:
            p = self.tok.encode(prompt, add_special_tokens=False)
            if self.bos_id is not None:
                p = [self.bos_id] + p
        t = self.tok.encode(target, add_special_tokens=False)
        if self.eos_id is not None:
            t = t + [self.eos_id]
        return list(p), t

    def option_token_ids(self, n_options: int) -> np.ndarray:
        return np.array(
            [self._encode_option(OPTION_LETTERS[i])[0] for i in range(n_options)],
            dtype=np.int32,
        )

    def option_token_seqs(self, n_options: int) -> np.ndarray:
        """Full per-option token sequences [C, T] (-1 padded) for the
        multi-token scoring fallback."""
        seqs = [self._encode_option(OPTION_LETTERS[i]) for i in range(n_options)]
        t = max(len(s) for s in seqs)
        out = np.full((n_options, t), -1, np.int32)
        for i, s in enumerate(seqs):
            out[i, : len(s)] = s
        return out


@dataclasses.dataclass
class TokenBatch:
    """Device-ready arrays for a whole dataset (or fold slice)."""

    tokens: np.ndarray  # int32 [N, L]
    loss_mask: np.ndarray  # float32 [N, L]
    answer_pos: np.ndarray  # int32 [N]
    lengths: np.ndarray  # int32 [N] true sequence lengths
    gold: np.ndarray  # int32 [N] gold option index, -1 for non-MCQ
    n_options: np.ndarray  # int32 [N] number of options, 0 for non-MCQ
    option_token_ids: np.ndarray  # int32 [max_options]
    pad_id: int
    #: [C, T] per-option token sequences (-1 padded) when the tokenizer
    #: violates the " A"-is-one-token invariant; None on the fast path
    option_token_seqs: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return self.tokens.shape[0]

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]


def tokenize_dataset(
    ds: BlindDataset,
    tokenizer,
    max_len: Optional[int] = None,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    include_context: bool = True,
    backend: str = "auto",
) -> TokenBatch:
    """Tokenize + right-pad a dataset into one fixed-shape :class:`TokenBatch`.

    Sequences longer than the cap are *head-truncated on the prompt's context*
    (the question/options tail is always kept — it carries the shortcut signal
    the diagnostic is hunting for).

    ``backend='auto'`` and ``'python'`` take the Python packing path, which
    is byte-identical to the reference's native C++ packer
    (``tst/data/tokenize.py:226-229``); the port has no copy of that packer
    yet (ROADMAP §1 item 19), so ``backend='native'`` raises
    NotImplementedError.
    """
    if backend not in ("auto", "python", "native"):
        raise ValueError(f"unknown tokenize backend {backend!r}")
    if backend == "native":
        raise NotImplementedError("native (C++) byte packing is not ported yet "
                                  "(ROADMAP item 19); use backend='python' or 'auto'")

    prompt_ids: List[List[int]] = []
    target_ids: List[List[int]] = []
    for s in ds:
        p, t = blind.render_example(s, include_context)
        pi, ti = tokenizer.encode_example(p, t)
        prompt_ids.append(pi)
        target_ids.append(ti)

    lengths = np.array([len(p) + len(t) for p, t in zip(prompt_ids, target_ids)])
    L = _resolve_len(lengths, max_len, buckets)

    n = len(ds)
    max_opts = max((len(s.options) for s in ds), default=0)
    tokens = np.full((n, L), tokenizer.pad_id, dtype=np.int32)
    loss_mask = np.zeros((n, L), dtype=np.float32)
    answer_pos = np.zeros(n, dtype=np.int32)
    true_len = np.zeros(n, dtype=np.int32)
    gold = np.full(n, -1, dtype=np.int32)
    n_opts = np.zeros(n, dtype=np.int32)

    for i, (s, p, t) in enumerate(zip(ds, prompt_ids, target_ids)):
        if len(p) + len(t) > L:
            # Head-truncate the prompt, keep its tail (question+options+marker).
            keep = L - len(t)
            if keep < 8:
                raise ValueError(f"sample {s.id}: target alone nearly fills bucket {L}")
            p = [p[0]] + p[len(p) - keep + 1 :]
        seq = p + t
        tokens[i, : len(seq)] = seq
        loss_mask[i, len(p) : len(seq)] = 1.0
        answer_pos[i] = len(p) - 1
        true_len[i] = len(seq)
        if s.answer_type == MCQ:
            gold[i] = s.answer_index
            n_opts[i] = len(s.options)

    return TokenBatch(
        tokens=tokens,
        loss_mask=loss_mask,
        answer_pos=answer_pos,
        lengths=true_len,
        gold=gold,
        n_options=n_opts,
        option_token_ids=tokenizer.option_token_ids(max_opts) if max_opts else np.zeros(0, np.int32),
        pad_id=tokenizer.pad_id,
        option_token_seqs=_option_seqs_if_needed(tokenizer, max_opts),
    )


def _option_seqs_if_needed(tokenizer, max_opts: int) -> Optional[np.ndarray]:
    """[C, T] option token sequences when the tokenizer needs the multi-token
    scoring fallback (single_token_options is False); None on the fast path."""
    if max_opts and not getattr(tokenizer, "single_token_options", True):
        return tokenizer.option_token_seqs(max_opts)
    return None


def pad_batch_n(tb: TokenBatch, multiple: int) -> Tuple[TokenBatch, np.ndarray]:
    """Pad the sample axis up to a multiple (for even sharding over the mesh).

    Returns (padded batch, validity mask [N_padded] with 1.0 on real rows).
    Pad rows duplicate row 0 but carry gold=-1 so they never count in metrics.
    """
    n = tb.n
    n_pad = (-n) % multiple
    if n_pad == 0:
        return tb, np.ones(n, dtype=np.float32)
    rep = lambda a: np.concatenate([a, np.repeat(a[:1], n_pad, axis=0)], axis=0)
    padded = TokenBatch(
        tokens=rep(tb.tokens),
        loss_mask=np.concatenate([tb.loss_mask, np.zeros((n_pad, tb.seq_len), np.float32)]),
        answer_pos=rep(tb.answer_pos),
        lengths=rep(tb.lengths),
        gold=np.concatenate([tb.gold, np.full(n_pad, -1, np.int32)]),
        n_options=rep(tb.n_options),
        option_token_ids=tb.option_token_ids,
        pad_id=tb.pad_id,
        option_token_seqs=tb.option_token_seqs,
    )
    valid = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    return padded, valid
