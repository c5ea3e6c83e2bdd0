#!/usr/bin/env python3
"""Speculative decode on the card: a round's wall against plain decode
steps, the port's counterpart of scripts/probe_spec_decode.py.

Exact speculative greedy decoding (tst_torch.models.spec_decode) commits
``E[accepted] + 1`` of the target's greedy tokens a round; whether it beats
plain greedy decode is arithmetic on two measured walls:

    speedup(alpha) = (sum_{j=1..gamma} alpha^j + 1) * t_target_step / t_round

where alpha is the draft's per-token agreement with the target (it depends
on the checkpoints and the traffic; random weights agree about nothing) and
t_round is gamma + 1 draft steps plus the target's (gamma + 1)-token verify
chunk. The break-even alpha is where the speedup is 1.

    python3 scripts/torch_probe_spec_decode.py [--batches 16 32] [--gammas 2 4]
        [--draft-quantize none|int8|int4] [--out FILE]

At the reference's serving shapes: an int8 Llama-3-8B target, a Llama-3.2-1B
draft in bf16 (``--draft-quantize none``), prompts of 512 byte tokens of the
synthetic MCQ benchmark, random weights from seeds 0 and 1. The draft is
unrelated to the target, so it is rejected at every position and a call
runs max_new - 1 rounds exactly (checked on its stats); the difference of
the walls at MAX_NEW and SHORT_NEW new tokens cancels both prefills. Both
decodes go through the kernels (K1 in the prefills, the decode attention,
K3 on an int4 draft). Prints one JSON line a batch (the target's step) and
one a (batch, gamma); ``--out FILE`` writes them to FILE as well. Needs a
card.
"""

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: new tokens a row of the timed calls, and of the short calls whose wall
#: the difference subtracts (the prefills cancel), and the timed repeats
MAX_NEW, SHORT_NEW, REPS = 16, 4, 3
#: the agreement rates of the printed speedup curve
ALPHAS = (0.5, 0.7, 0.8, 0.9)
#: the reference's serving pair: the target and its weights' bits, the
#: draft, and the prompts' length
TARGET, TARGET_BITS, DRAFT, SEQ = "llama3-8b", 8, "llama3.2-1b", 512
#: --draft-quantize's choices, as bits (None: bf16)
BITS = {"none": None, "int8": 8, "int4": 4}


def expected_commits(alpha, gamma):
    """Tokens a round commits when each draft token agrees with probability
    ``alpha``: the accepted prefix's expected length, plus the bonus."""
    return sum(alpha ** j for j in range(1, gamma + 1)) + 1.0


def break_even_alpha(ratio, gamma, iters=60):
    """The alpha at which expected_commits(alpha, gamma) equals ``ratio``
    (t_round / t_target_step), by bisection on [0, 1]; NaN where even a
    draft that always agrees (gamma + 1 tokens a round) does not pay."""
    if ratio > gamma + 1:
        return float("nan")
    lo, hi = 0.0, 1.0
    for _ in range(iters):
        mid = (lo + hi) / 2
        if expected_commits(mid, gamma) < ratio:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def step_ms(wall_long, wall_short, steps):
    """ms a step by the difference method: the walls of two calls that
    differ by ``steps`` steps; None where the longer call is not the slower
    (the noise floor)."""
    if wall_long <= wall_short:
        return None
    return (wall_long - wall_short) / steps * 1e3


def prompts(seq, device, n=256):
    """[n, seq] byte-token prompts of the synthetic MCQ benchmark (half of
    its rows with the planted bias, seed 0) and their lengths through the
    answer position."""
    from tst_torch.data.synthetic import make_synthetic_mcq
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset

    tb = tokenize_dataset(make_synthetic_mcq(n=n, bias_fraction=0.5, seed=0), ByteTokenizer(),
                          max_len=seq)
    return (torch.from_numpy(tb.tokens).to(device),
            torch.from_numpy(tb.answer_pos).to(device).long() + 1)


def walls(fn, reps=REPS):
    """{n_new: seconds a call of fn(n_new)} at MAX_NEW and SHORT_NEW, each
    after one untimed call, over ``reps`` synchronized calls."""
    out = {}
    for n_new in (MAX_NEW, SHORT_NEW):
        fn(n_new)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(n_new)
        torch.cuda.synchronize()
        out[n_new] = (time.perf_counter() - t0) / reps
    return out


def build(name, seed, bits, device):
    """A random init of ``name`` from ``seed`` on ``device``, quantized to
    ``bits`` (None: kept in bf16)."""
    from tst_torch.models.decoder import init_params
    from tst_torch.models.quant import quantize_params
    from tst_torch.models.spec import spec_by_name

    spec = spec_by_name(name, dtype=torch.bfloat16)
    params = init_params(torch.Generator(device=device).manual_seed(seed), spec)
    return spec, quantize_params(params, bits=bits) if bits else params


def main(argv=None):
    from tst_torch.models.decode import greedy_decode
    from tst_torch.models.spec_decode import speculative_greedy_decode
    from tst_torch.runtime.device import select_device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batches", type=int, nargs="+", default=[16, 32])
    parser.add_argument("--gammas", type=int, nargs="+", default=[2, 4])
    parser.add_argument("--draft-quantize", default="none", choices=list(BITS))
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    device = select_device("gpu")
    tspec, tparams = build(TARGET, 0, TARGET_BITS, device)
    dspec, dparams = build(DRAFT, 1, BITS[args.draft_quantize], device)
    tokens, plen = prompts(SEQ, device)
    card = torch.cuda.get_device_name(0)
    lines = []

    def emit(rec):
        rec = {"device": card, **rec}
        print(json.dumps(rec), flush=True)
        lines.append(rec)

    for b in args.batches:
        rows = torch.arange(b, device=device) % tokens.shape[0]
        toks, pl = tokens[rows], plen[rows]

        def plain(n_new):
            with torch.inference_mode():
                return greedy_decode(tparams, toks, pl, n_new, tspec, use_pallas=True)

        w = walls(plain)
        t_step = step_ms(w[MAX_NEW], w[SHORT_NEW], MAX_NEW - SHORT_NEW)
        emit({"batch": b, "target": f"{TARGET} int{TARGET_BITS}",
              "t_target_step_ms": t_step, "walls_s": w,
              "steps_tokens_per_s": None if t_step is None else b * 1e3 / t_step})
        if t_step is None:
            continue
        for gamma in args.gammas:
            def spec(n_new, gamma=gamma):
                with torch.inference_mode():
                    out, stats = speculative_greedy_decode(
                        dparams, dspec, tparams, tspec, toks, pl, n_new, gamma=gamma,
                        use_pallas=True, return_stats=True)
                if stats["rounds"] != n_new - 1:
                    raise AssertionError(f"an unrelated draft should be rejected at every "
                                         f"position: {stats['rounds']} rounds for {n_new} "
                                         f"tokens")
                return out

            w = walls(spec)
            t_round = step_ms(w[MAX_NEW], w[SHORT_NEW], MAX_NEW - SHORT_NEW)
            ratio = None if t_round is None else t_round / t_step
            alpha = None if ratio is None else break_even_alpha(ratio, gamma)
            emit({"batch": b, "gamma": gamma,
                  "draft": f"{DRAFT} {args.draft_quantize}", "t_round_ms": t_round,
                  "walls_s": w, "round_in_target_steps": ratio,
                  # null: no alpha pays (a round costs more than gamma + 1 steps)
                  "break_even_alpha": alpha if alpha is not None and alpha == alpha else None,
                  "speedup": None if ratio is None else {
                      str(a): expected_commits(a, gamma) / ratio for a in ALPHAS}})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
