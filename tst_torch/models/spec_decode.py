"""Exact speculative greedy decoding (counterpart of
``tst/models/spec_decode.py``): a cheap draft model proposes, the target
verifies, and the committed tokens are the target's greedy tokens.

Per round:

  1. the draft decodes ``gamma`` tokens one by one (``gamma + 1`` single
     steps: the last feeds the last draft token, so the draft's cache covers
     every slot of the round's chunk);
  2. the target runs one ``gamma + 1``-token chunk step over ``[x_last,
     d_1..d_gamma]`` (``tst_torch.models.decode._chunk_step``), giving its
     greedy token after every prefix;
  3. the longest prefix of draft tokens that matches the target's choices is
     committed, then the target's own next token (the bonus): every round
     commits ``accepted + 1 >= 1`` tokens.

The cache layout is the reference's: append-only slots shared by all rows.
Round r writes its chunk's K/V at ``[base, base + gamma + 1)`` for every
row; a row that rejects a suffix never marks those slots valid, and a
``[B, S_max]`` validity mask replaces compaction. RoPE positions and output
columns advance per row; the slot base advances by ``gamma + 1`` a round.
The cache holds ``S + max_new · (gamma + 1)`` slots padded to a multiple of
128, the worst case (one token a round), as in the reference.

The reference runs the rounds in ``lax.while_loop`` with static shapes;
eager torch runs them as a Python loop, which ends when every row has
``max_new`` tokens. The numbers are the reference's: the draft sees the
target's tokens clipped to its vocabulary, a draft whose vocabulary is
wider than the target's is refused, and the draft never carries adapters.
Attention over the cache and the projections are the greedy decode's
(int4 weights through K3 with ``use_pallas``: the verify chunk's M is
rows · (gamma + 1)); the prefills go through the flash kernel K1. A row's
logits in the verify chunk are the bits of greedy decode's steps
(tst_torch.models.decode: K3's rows do not depend on M, the attention
kernel sums by the visible slots' ranks, and every other product runs a
chunk position at a time, at a greedy step's shape), so the tokens are
greedy decode's on the card too.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from tst_torch.models.decode import _chunk_step, prefill
from tst_torch.models.lora import LoraSpec
from tst_torch.models.spec import ModelSpec
from tst_torch.runtime import mesh as mesh_mod


def speculative_greedy_decode(
    draft_params,
    draft_spec: ModelSpec,
    target_params,
    target_spec: ModelSpec,
    tokens: torch.Tensor,  # int [B, S] right-padded prompts
    prompt_len: torch.Tensor,  # int [B]
    max_new: int,
    gamma: int = 4,
    lora=None,
    lora_spec: Optional[LoraSpec] = None,
    use_pallas: bool = False,
    return_stats: bool = False,
    mesh=None,
) -> Union[torch.Tensor, Tuple[torch.Tensor, dict]]:
    """Greedy continuation of each prompt → int32 [B, max_new], equal to
    ``greedy_decode(target_params, ...)``.

    ``gamma``: draft tokens proposed a round. ``lora`` / ``lora_spec`` apply
    to the target (single, or fold-stacked with fold-major rows); the draft
    runs its base weights. ``return_stats`` also returns ``{"rounds": int,
    "committed": int [B]}``: the rounds run, and the tokens each row
    committed (>= max_new at the end; a row keeps counting once full).
    ``mesh``: target and draft weights are this rank's shards (the decode
    step's projections under tensor and FSDP)."""
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    if draft_spec.vocab_size > target_spec.vocab_size:
        raise ValueError(
            f"draft vocab ({draft_spec.vocab_size}) exceeds target vocab "
            f"({target_spec.vocab_size}); draft ids must be valid target embedding indices")
    b, s = tokens.shape
    chunk = gamma + 1
    slots = s + max_new * chunk  # worst case: one token a round
    s_max = slots + (-slots) % 128
    device = tokens.device
    prompt_len = prompt_len.to(device).long()
    clip = draft_spec.vocab_size < target_spec.vocab_size
    with torch.inference_mode():
        first, tk, tv, thead, trope = prefill(
            target_params, tokens, prompt_len, max_new, target_spec, lora=lora,
            lora_spec=lora_spec, use_pallas=use_pallas, pad_to=s_max, mesh=mesh)
        _, dk, dv, dhead, drope = prefill(draft_params, tokens, prompt_len, max_new, draft_spec,
                                          use_pallas=use_pallas, pad_to=s_max, mesh=mesh)
        ar = torch.arange(s_max, device=device)[None, :]
        jpos = torch.arange(chunk, device=device)[None, :]
        rows = torch.arange(b, device=device)[:, None].expand(b, chunk)
        out = torch.zeros((b, max_new), dtype=torch.int32, device=device)
        out[:, 0] = first
        x_last, pos_last = first, prompt_len
        n_out = torch.ones(b, dtype=torch.long, device=device)
        valid = ar < prompt_len[:, None]  # [B, S_max]: committed slots
        base, rounds = s, 0
        while (max_new > 1 and base + chunk <= s_max
               and mesh_mod.any_over(int(n_out.min()) < max_new, mesh, ("data",))):
            # the draft: gamma + 1 single steps over this round's slots
            cur, fed = x_last, []
            for j in range(chunk):
                cur_d = cur.clamp_max(draft_spec.vocab_size - 1) if clip else cur
                vmask = valid | ((ar >= base) & (ar < base + j))
                nxt, dk, dv = _chunk_step(
                    draft_params, None, None, draft_spec, cur_d[:, None],
                    (pos_last + j)[:, None], base + j, vmask, dk, dv,
                    use_pallas=use_pallas, head=dhead, rope=drope, mesh=mesh)
                fed.append(cur)  # the true token: the target verifies it
                cur = nxt[:, 0]
            chunk_tok = torch.stack(fed, dim=1)  # [B, chunk]: [x_last, d_1..d_gamma]
            d = chunk_tok[:, 1:]
            # the target: one chunk step; tgt[:, j] follows [.., x_last, d_1..d_j]
            tgt, tk, tv = _chunk_step(
                target_params, lora, lora_spec, target_spec, chunk_tok,
                pos_last[:, None] + jpos, base, valid, tk, tv, use_pallas=use_pallas,
                head=thead, rope=trope, mesh=mesh)
            # acceptance: the longest prefix where the draft matched
            acc = (d == tgt[:, :gamma]).long().cumprod(dim=1).sum(dim=1)  # [B] in 0..gamma
            bonus = tgt.gather(1, acc[:, None])[:, 0]
            # commit d_1..d_acc, then the bonus, per row
            cand = torch.where(jpos < acc[:, None], torch.nn.functional.pad(d, (0, 1)),
                               bonus[:, None])
            cols = n_out[:, None] + jpos
            write = (jpos <= acc[:, None]) & (cols < max_new)
            out[rows[write], cols[write]] = cand[write]
            # slots base..base+acc hold [x_last, d_1..d_acc]: all committed
            valid = valid | ((ar >= base) & (ar - base <= acc[:, None]))
            x_last = bonus
            n_out = n_out + acc + 1
            pos_last = pos_last + acc + 1
            base += chunk
            rounds += 1
    if return_stats:
        return out, {"rounds": rounds, "committed": n_out}
    return out
