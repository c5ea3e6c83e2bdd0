"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

``entry()``              — the flagship forward: Qwen2.5-0.5B's geometry in
                           bf16, random weights, ``apply_model`` on a
                           ``[4, 512]`` batch; on the card every layer runs
                           the flash-attention forward kernel.
``dryrun_multichip(n)``  — every leg of the reference's dry run over an
                           n-rank ``(fold, data, seq, tensor)`` mesh: the
                           fold-parallel LoRA step (the ring over ``seq``),
                           the packed step, the held-out scorer, fold-stacked
                           greedy decode, speculative decode held equal to
                           greedy decode (plain and fold-stacked), and ring
                           attention over n blocks against the plain causal
                           attention.

    python -m tst_torch.graft_entry [n] [--platform gpu|cpu]
    torchrun --nproc-per-node n -m tst_torch.graft_entry n

On cards (``gpu``, the default) a rank is a process on its own card and the
ranks talk over NCCL; ``dryrun_multichip`` starts them itself, or joins the
ranks ``torchrun`` started. ``cpu`` starts n host processes over gloo (the
counterpart of the reference's virtual CPU devices). Neither falls back to
the other.

One departure: the kernels take head widths 64 and 128, and ``tiny`` has
16, so on cards the dry run's model is ``tiny`` with ``d_head=64`` (every
other width ``tiny``'s); on the CPU it is ``tiny`` unchanged.
"""

from __future__ import annotations

import argparse
import math
import sys
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from tst_torch.runtime import mesh as mesh_mod
from tst_torch.runtime.device import PLATFORMS, select_device

#: seconds the spawned ranks have to finish the dry run
DEADLINE_S = 900
#: the held-out rows a fold, and the tokens, of the decode legs
DECODE_ROWS = 4
MAX_NEW = 4
GAMMA = 2
#: the ring leg: positions a rank, its chunk, heads and head width
RING_BLOCK = 128
RING_HEADS, RING_DIM = 4, 16
RING_TOL = 1e-4
#: ``against_plain``: legs 1-4 again on the plain path from the same state,
#: held to the port's rules for bf16 kernels against their plain path: the
#: per-fold losses within LOSS_RTOL of the plain loss and every LoRA
#: gradient leaf at cosine >= GRAD_COSINE (one step), the held-out letter
#: probabilities within PROB_TOL, the first decode step's logits within
#: LOGIT_TOL · max|logit| with no decisive first-token disagreement
LOSS_RTOL, GRAD_COSINE, PROB_TOL, LOGIT_TOL = 1e-3, 0.99, 0.05, 2e-2
#: scale of the LoRA B drawn for those comparisons: B starts at 0 (and one
#: step of the warmup schedule leaves it there), which makes every adapter
#: a no-op and every A-gradient 0
B_SCALE = 0.005


def entry(platform: str = "gpu", **overrides):
    """(fn, (params, tokens)): ``fn(params, tokens)`` is the forward of
    Qwen2.5-0.5B's geometry (d_model 896, 24 layers, 14/2 heads, d_head 64,
    vocab 151936) in bf16 → f32 logits [4, 512, vocab]; the weights are
    random, from a generator seeded 0 on the device. On the card the
    attention is the flash-attention kernel; ``platform="cpu"`` takes the
    plain attention. ``overrides`` replace widths of the spec (small CPU
    tests)."""
    from tst_torch.models.decoder import apply_model, init_params
    from tst_torch.models.spec import spec_by_name

    device = select_device(platform)
    spec = spec_by_name("qwen2.5-0.5b", **overrides)
    params = init_params(torch.Generator(device).manual_seed(0), spec)
    tokens = torch.ones((4, 512), dtype=torch.int64, device=device)
    use_pallas = device.type == "cuda"

    def fn(params, tokens):
        with torch.inference_mode():
            return apply_model(params, tokens, spec, use_pallas=use_pallas)

    return fn, (params, tokens)


def mesh_shape(n: int) -> Dict[str, int]:
    """The reference's factorization of n ranks, from the inside out:
    tensor=2 when n is even, then seq=2, then fold=2; data takes the rest."""
    tensor = 2 if n % 2 == 0 else 1
    rest = n // tensor
    seq = 2 if rest % 2 == 0 else 1
    rest //= seq
    fold = 2 if rest % 2 == 0 else 1
    return {"fold": fold, "data": rest // fold, "seq": seq, "tensor": tensor}


def ok_line(result: Dict[str, Any]) -> str:
    """The reference's line for a dry run's result."""
    m = result["mesh"]
    return (f"dryrun_multichip OK: mesh fold={m['fold']} data={m['data']} seq={m['seq']} "
            f"tensor={m['tensor']}, k={result['k']}, loss={result['loss']:.3f}, "
            f"packed_loss={result['packed_loss']:.3f}, decode={tuple(result['decode'])}, "
            f"spec_exact={result['spec_exact']}, ring_err={result['ring_err']:.2e}")


def check_result(result: Dict[str, Any], n: int, against_plain: bool = False) -> None:
    """Raise unless ``result`` is a passed dry run of n ranks: the mesh
    factored as :func:`mesh_shape` factors n, k = 2 · fold, finite losses,
    decode (k, 4, 4), spec_exact, the ring within RING_TOL; with
    ``against_plain`` also every leg's reading against the plain path
    within its rule."""
    k = result["k"]
    bad = [what for what, ok in (
        ("mesh", result["mesh"] == mesh_shape(n)), ("k", k == 2 * result["mesh"]["fold"]),
        ("decode", list(result["decode"]) == [k, DECODE_ROWS, MAX_NEW]),
        ("spec_exact", result["spec_exact"] is True),
        ("losses", math.isfinite(result["loss"]) and math.isfinite(result["packed_loss"])),
        ("ring_err", result["ring_err"] < RING_TOL)) if not ok]
    if against_plain:
        vs = result.get("vs_plain")
        if vs is None:
            bad.append("vs_plain missing")
        else:
            bad += [what for what, ok in (
                ("step", vs["step"]["loss_gap"] <= LOSS_RTOL
                 and vs["step"]["grad_cosine"] >= GRAD_COSINE),
                ("packed_step", vs["packed_step"]["loss_gap"] <= LOSS_RTOL
                 and vs["packed_step"]["grad_cosine"] >= GRAD_COSINE),
                ("scorer", vs["scorer"]["max_dprob"] <= PROB_TOL),
                ("decode", vs["decode"]["max_dlogit_rel"] <= LOGIT_TOL
                 and vs["decode"]["decisive"] == 0)) if not ok]
    if bad:
        raise AssertionError(f"dryrun_multichip({n}): {bad} failed in {result}")


def _probe(trainer, lora):
    """This rank's part of the adapters ``lora`` with every B drawn nonzero
    (B_SCALE, a generator seeded 7, over the whole tree: one state on any
    mesh)."""
    whole = {p: dict(ab) for p, ab in trainer.global_tree(lora).items()}
    device = next(iter(whole.values()))["b"].device
    g = torch.Generator(device).manual_seed(7)
    for ab in whole.values():
        ab["b"] = (B_SCALE * torch.randn(ab["b"].shape, generator=g, device=device)).to(
            ab["b"].dtype)
    return trainer.local_tree(whole)


def _step_vs_plain(kernel, plain, params, lora, arrays, idx_kb, segs=None) -> Dict[str, Any]:
    """One batch's per-fold losses and LoRA gradients through ``kernel``
    (a FoldTrainer) and ``plain`` (the same, use_pallas=False) on one state
    → the loss gap (max over folds of |d| / |plain|) and the smallest
    gradient cosine over the whole adapters' leaves."""
    (lk, gk), (lp, gp) = (t.batch_loss_and_grads(params, lora, *arrays, idx_kb, segs)
                          for t in (kernel, plain))
    gk, gp = kernel.global_tree(gk), kernel.global_tree(gp)
    cos = min(torch.nn.functional.cosine_similarity(
        gk[p][m].float().flatten(), gp[p][m].float().flatten(), dim=0).item()
        for p in gk for m in gk[p])
    gap = float(((lk.double() - lp.double()).abs() / lp.double().abs()).max())
    return {"loss_gap": gap, "grad_cosine": cos}


def _decode_vs_plain(params, lora, spec, lspec, tokens, pos, rows, mesh) -> Dict[str, Any]:
    """The first decode step of this rank's folds' held-out ``rows`` ([k,
    M], fold-stacked adapters, the caches of one prefill) through the
    kernels and through the plain path → max|dlogit| / max|logit| and the
    first-token disagreements: decisive where the plain path's top-2 gap
    exceeds twice the error the rule lets through."""
    from tst_torch.models.decode import chunk_logits, prefill

    folds = mesh_mod.fold_range(rows.shape[0], mesh)
    sel = torch.from_numpy(rows[folds.start: folds.stop].reshape(-1).astype(np.int64)).to(
        tokens.device)
    tok, plen = tokens[sel], pos[sel].long() + 1
    with torch.inference_mode():
        tok0, kc, vc, head, rope = prefill(params, tok, plen, MAX_NEW, spec, lora=lora,
                                           lora_spec=lspec, use_pallas=True, mesh=mesh)
        valid = torch.arange(kc.shape[2], device=tok.device)[None, :] < plen[:, None]
        lk, lp = (chunk_logits(params, lora, lspec, spec, tok0[:, None], plen[:, None],
                               tok.shape[1], valid, kc.clone(), vc.clone(), use_pallas=up,
                               head=head, rope=rope, mesh=mesh)[0][:, 0] for up in (True, False))
    top2 = lp.topk(2, dim=-1).values
    differ = lk.argmax(-1) != lp.argmax(-1)
    decisive = differ & (top2[:, 0] - top2[:, 1] > 2 * LOGIT_TOL * lp.abs().max())
    return {"max_dlogit_rel": float((lk - lp).abs().max() / lp.abs().max()),
            "differ": int(differ.sum()), "decisive": int(decisive.sum())}


def _legs(n: int, platform: str, against_plain: bool = False) -> Dict[str, Any]:
    """The dry run's legs on this rank, in the reference's order, at its
    sizes; raises on any failed check → the values of the OK line (and,
    with ``against_plain``, legs 1-4's readings against the plain path)."""
    from tst_torch.data.folds import kfold_assign
    from tst_torch.data.packing import make_packed_fold_batches, pack_fold_datasets
    from tst_torch.data.synthetic import make_synthetic_mcq
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.kernels.flash_attention import flash_attention_reference
    from tst_torch.kernels.ring_attention import ring_attention
    from tst_torch.models.decode import greedy_decode
    from tst_torch.models.decoder import init_params
    from tst_torch.models.lora import LoraSpec
    from tst_torch.models.spec import spec_by_name
    from tst_torch.models.spec_decode import speculative_greedy_decode
    from tst_torch.train.infer import _decode_heldout_rows, score_heldout_mcq
    from tst_torch.train.sft import FoldTrainer, make_fold_batches

    device = select_device(platform)
    on_card = device.type == "cuda"
    shape = mesh_shape(n)
    mesh = mesh_mod.make_mesh(**shape)
    fold, data, seq = shape["fold"], shape["data"], shape["seq"]
    k = 2 * fold  # the fold axis must divide k
    spec = spec_by_name("tiny", **({"d_head": 64} if on_card else {}))
    lspec = LoraSpec(rank=4, alpha=8.0)

    ds = make_synthetic_mcq(n=16 * k, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=512)
    fold_id = kfold_assign(ds, k, seed=0)
    batches = make_fold_batches(fold_id, k, batch_size=2 * data, epochs=1, seed=0,
                                batch_multiple=data)
    params = init_params(torch.Generator(device).manual_seed(0), spec)
    params = mesh_mod.shard_tree(params, mesh_mod.param_pspec_tree(params), mesh)
    tokens, mask, pos = (torch.from_numpy(np.asarray(a)).to(device)
                         for a in (tb.tokens, tb.loss_mask, tb.answer_pos))
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))

    # 1. the fold-parallel train step (sequence-parallel through the ring)
    trainer = FoldTrainer(spec, lspec, k=k, lr=1e-3, total_steps=1, mesh=mesh, t_max=t_max,
                          ring=seq > 1, use_pallas=on_card)
    lora, opt = trainer.init_state(torch.Generator(device).manual_seed(1))
    lora, opt, log = trainer.fit(params, lora, opt, tokens, mask, batches[:1], all_pos=pos,
                                 log_every=1)
    if not np.isfinite(log.losses[-1]):
        raise FloatingPointError(f"non-finite loss {log.losses}")
    vs_plain: Dict[str, Any] = {}
    if against_plain:  # legs 1-4 on one state whose adapters act: the trained A, B drawn
        probe = _probe(trainer, lora)
        plain = FoldTrainer(spec, lspec, k=k, lr=1e-3, total_steps=1, mesh=mesh, t_max=t_max,
                            ring=seq > 1, use_pallas=False)
        vs_plain["step"] = _step_vs_plain(trainer, plain, params, probe, (tokens, mask, pos),
                                          batches[0])

    # 2. the packed step over the same mesh (segment-masked attention)
    fp = pack_fold_datasets(tb, fold_id, k, pack_len=1024)
    pbatches = make_packed_fold_batches(fp.n_rows, batch_size=1 * data, epochs=1, seed=0,
                                        batch_multiple=data)
    ptrainer = FoldTrainer(spec, lspec, k=k, lr=1e-3, total_steps=1, mesh=mesh, t_max=t_max,
                           packed=True, use_pallas=on_card)
    plora, popt = ptrainer.init_state(torch.Generator(device).manual_seed(2))
    ptok, pmask, ppos, psegs = (torch.from_numpy(np.asarray(a)).to(device)
                                for a in (fp.tokens, fp.loss_mask, fp.answer_pos,
                                          fp.seg_starts))
    _, _, plog = ptrainer.fit(params, plora, popt, ptok, pmask, pbatches[:1], all_pos=ppos,
                              all_segs=psegs, n_segs=fp.n_segs, log_every=1)
    if not np.isfinite(plog.losses[-1]):
        raise FloatingPointError(f"non-finite packed loss {plog.losses}")
    if against_plain:
        pplain = FoldTrainer(spec, lspec, k=k, lr=1e-3, total_steps=1, mesh=mesh, t_max=t_max,
                             packed=True, use_pallas=False)
        vs_plain["packed_step"] = _step_vs_plain(ptrainer, pplain, params, probe,
                                                 (ptok, pmask, ppos), pbatches[0], psegs)

    # 3. the fold-parallel held-out scorer
    probs = score_heldout_mcq(params, lora, spec, lspec, tokens, pos, tb.option_token_ids,
                              tb.n_options, fold_id, k, use_pallas=on_card, batch=8, mesh=mesh)
    if not np.isfinite(probs).all():
        raise FloatingPointError("non-finite held-out probabilities")
    if against_plain:
        pk, pp = (score_heldout_mcq(params, probe, spec, lspec, tokens, pos,
                                    tb.option_token_ids, tb.n_options, fold_id, k,
                                    use_pallas=up, batch=8, mesh=mesh) for up in (on_card, False))
        vs_plain["scorer"] = {"max_dprob": float(np.abs(pk - pp).max())}

    # 4. fold-stacked greedy decode of each fold's first held-out rows
    rows = np.stack([np.flatnonzero(fold_id == f)[:DECODE_ROWS] for f in range(k)])
    gen, _, _ = _decode_heldout_rows(params, lora, spec, lspec, tokens, pos, rows.reshape(-1),
                                     fold_id, k, MAX_NEW, on_card, chunk=DECODE_ROWS,
                                     mesh=mesh)
    if gen.shape != (k, DECODE_ROWS, MAX_NEW):
        raise ValueError(f"decode shape {gen.shape}")
    if against_plain:
        vs_plain["decode"] = _decode_vs_plain(params, probe, spec, lspec, tokens, pos, rows,
                                              mesh)

    # 5. speculative decode (a second random draft, both sharded) equal to greedy
    draft = init_params(torch.Generator(device).manual_seed(3), spec)
    draft = mesh_mod.shard_tree(draft, mesh_mod.param_pspec_tree(draft), mesh)
    stoks, splen = tokens[:DECODE_ROWS], pos[:DECODE_ROWS].long() + 1
    want = greedy_decode(params, stoks, splen, MAX_NEW, spec, use_pallas=on_card, mesh=mesh)
    got = speculative_greedy_decode(draft, spec, params, spec, stoks, splen, MAX_NEW,
                                    gamma=GAMMA, use_pallas=on_card, mesh=mesh)
    if not torch.equal(got, want):
        raise AssertionError("speculative decode diverged from greedy under the mesh")

    # 6. fold-stacked speculative decode equal to leg 4's tokens
    sgen, _, _ = _decode_heldout_rows(params, lora, spec, lspec, tokens, pos, rows.reshape(-1),
                                      fold_id, k, MAX_NEW, on_card, chunk=DECODE_ROWS,
                                      draft=(spec, draft), gamma=GAMMA, mesh=mesh)
    if not np.array_equal(sgen, gen):
        raise AssertionError("fold-stacked speculative decode diverged from greedy under "
                             "the mesh")

    # 7. ring attention over a seq group of all n ranks against plain attention
    seq_mesh = mesh_mod.make_mesh(seq=n)
    rng = np.random.default_rng(0)
    q, kk, v = (torch.from_numpy(rng.normal(size=(1, RING_BLOCK * n, RING_HEADS, RING_DIM))
                                 .astype(np.float32) * 0.3).to(device) for _ in range(3))
    r = seq_mesh.index("seq")
    blk = slice(r * RING_BLOCK, (r + 1) * RING_BLOCK)
    with torch.no_grad():
        out = ring_attention(q[:, blk], kk[:, blk], v[:, blk], seq_mesh, seq_axis="seq",
                             chunk=RING_BLOCK, use_pallas=False)  # f32, D=16: the plain route
        out = mesh_mod.gather_seq(out, seq_mesh)
        ref, _ = flash_attention_reference(q, kk, v, True)
    err = float((out - ref).abs().max())
    if not err < RING_TOL:
        raise AssertionError(f"ring attention mismatch: {err}")
    result = {"mesh": shape, "k": k, "loss": float(log.losses[-1]),
              "packed_loss": float(plog.losses[-1]), "decode": list(gen.shape),
              "spec_exact": True, "ring_err": err}
    if against_plain:
        result["vs_plain"] = vs_plain
    check_result(result, n, against_plain)
    return result


def _backend(platform: str) -> str:
    return "nccl" if platform == "gpu" else "gloo"


def _rank_legs(rank: int, world: int, platform: str, against_plain: bool) -> Dict[str, Any]:
    """The legs on one rank that :func:`dryrun_multichip` spawned."""
    return _legs(world, platform, against_plain)


def dryrun_multichip(n_devices: int, platform: str = "gpu",
                     against_plain: bool = False) -> Dict[str, Any]:
    """Every leg of the reference's dry run over an n-rank mesh (factored by
    :func:`mesh_shape`); prints the reference's OK line and returns its
    values (:func:`check_result` holds them); raises on any failed check.

    ``gpu``: one rank a card over NCCL; raises unless there are n cards.
    Inside a launch of n ranks (``torchrun``) this process is one of them;
    else n = 1 runs here, and n > 1 spawns n processes, one a card.
    ``cpu``: n host processes over gloo (n = 1 runs here).
    ``against_plain``: legs 1-4 run again on the plain path from the same
    state, and each is held to the plain path's (``vs_plain``)."""
    if platform not in PLATFORMS:
        raise ValueError(f"unknown platform {platform!r}; have {PLATFORMS}")
    if platform == "gpu":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}): needs {n_devices} cards, "
                               f"{have} available (platform='cpu' runs the ranks on the host)")
    joined_here = not (dist.is_available() and dist.is_initialized())
    if mesh_mod.init_distributed(backend=_backend(platform)):
        try:
            world = dist.get_world_size()
            if world != n_devices:
                raise ValueError(f"dryrun_multichip({n_devices}) inside a launch of {world} "
                                 "ranks")
            result = _legs(n_devices, platform, against_plain)
            rank = dist.get_rank()
            dist.barrier()
        finally:
            if joined_here:
                dist.destroy_process_group()
        if rank != 0:
            return result
    elif n_devices == 1:
        result = _legs(1, platform, against_plain)
    else:
        result = mesh_mod.spawn_ranks(_rank_legs, n_devices, _backend(platform), platform,
                                      against_plain, deadline_s=DEADLINE_S)[0]
    print(ok_line(result), flush=True)
    return result


def main(argv: Optional[list] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n", nargs="?", type=int, default=8, help="ranks of the mesh")
    parser.add_argument("--platform", choices=PLATFORMS, default="gpu")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n, platform=args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
