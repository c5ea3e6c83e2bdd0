"""Rank functions for the port's multi-process tests (gloo on the CPU).

Spawned processes re-import the module of the function they run, so this
module imports torch, numpy and the port only: never jax, never a test
module. :func:`run_ranks` starts ``world`` gloo processes through the
port's own spawner (tst_torch.runtime.mesh ``spawn_ranks``), each with one
torch thread and a process-group timeout of its own; on the deadline it
kills them and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from tst_torch.runtime.mesh import spawn_ranks

#: seconds a rank's collective waits before it fails
PG_TIMEOUT_S = 60


def run_ranks(fn, world: int, *args, deadline_s: float = 240.0):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo processes → the
    list of their results by rank. Raises with a rank's traceback if it
    failed, or when the deadline passes (its processes killed)."""
    return spawn_ranks(fn, world, "gloo", *args, deadline_s=deadline_s, timeout_s=PG_TIMEOUT_S)


# ---------------------------------------------------------------------------
# rank functions


def ring_rank(rank, world, cases, use_pallas=False):
    """Ring attention of this rank's sequence block over a seq mesh of
    ``world``, for each case (q, k, v, do[, causal]; causal by default),
    through K1 with ``use_pallas`` (its plain versions here): [o block, dq
    block, dk block, dv block] a case."""
    from tst_torch.kernels.ring_attention import ring_attention
    from tst_torch.runtime import mesh as tmesh

    mesh = tmesh.make_mesh(seq=world)
    out = []
    for q, k, v, do, *causal in cases:
        s = q.shape[1] // world
        blk = slice(rank * s, (rank + 1) * s)
        qb, kb, vb = (torch.from_numpy(np.ascontiguousarray(a[:, blk])).requires_grad_(True)
                      for a in (q, k, v))
        o = ring_attention(qb, kb, vb, mesh, seq_axis="seq", chunk=16,
                           causal=causal[0] if causal else True, use_pallas=use_pallas)
        grads = torch.autograd.grad(o, (qb, kb, vb),
                                    torch.from_numpy(np.ascontiguousarray(do[:, blk])))
        out.append([o.detach().numpy()] + [g.numpy() for g in grads])
    return out


def _tiny_setup(spec_name="tiny", k=2, quantize=None, **overrides):
    """A small spec in f32 (``overrides`` on its geometry), random weights
    from a torch seed (quantized with ``quantize`` bits), synthetic MCQ rows
    and their folds: what every rank and the one-process run build alike."""
    from tst_torch.data.adapters import load_benchmark
    from tst_torch.data.folds import kfold_assign
    from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst_torch.models.decoder import init_params
    from tst_torch.models.quant import quantize_params
    from tst_torch.models.spec import spec_by_name

    spec = spec_by_name(spec_name, dtype=torch.float32, **overrides)
    params = init_params(torch.Generator().manual_seed(0), spec)
    if quantize:
        params = quantize_params(params, bits=quantize)
    ds = load_benchmark("synthetic:0.5", n=24, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=128)
    return spec, params, tb, kfold_assign(ds, k, 0)


def train_one(shape, steps=3, k=2, batch=4, ring=False, remat=False, use_pallas=False,
              fused_mlp=False, quantize=None, spec_name="tiny", overrides=None,
              params_np=None, lora_np=None, dropout=0.0):
    """A few FoldTrainer steps and the held-out MCQ scorer on the mesh
    ``shape`` = (fold, data, seq, tensor) → (per-fold losses [steps, k], the
    held-out probabilities [N, C], the whole adapters after training).
    ``params_np`` / ``lora_np`` replace the base and the initial adapters
    (numpy trees, e.g. the JAX package's). LoRA r4 on q, k, v, o and down
    (both row-parallel projections), ``dropout`` its train-time dropout. A
    shape of one rank runs in the calling process."""
    from tst_torch import bridge
    from tst_torch.models.lora import LoraSpec
    from tst_torch.runtime import mesh as tmesh
    from tst_torch.train.infer import score_heldout_mcq
    from tst_torch.train.sft import FoldTrainer, make_fold_batches

    mesh = tmesh.make_mesh(fold=shape[0], data=shape[1], seq=shape[2], tensor=shape[3])
    spec, params, tb, fold_id = _tiny_setup(spec_name, k=k, quantize=quantize,
                                            **(overrides or {}))
    if params_np is not None:
        params = bridge.to_torch(params_np)
    lspec = LoraSpec(rank=4, alpha=8.0, dtype=torch.float32, dropout=dropout,
                     targets=("q_proj", "k_proj", "v_proj", "o_proj", "down_proj"))
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    batches = make_fold_batches(fold_id, k, batch, 2, seed=0, batch_multiple=shape[1])[:steps]
    trainer = FoldTrainer(spec, lspec, k, lr=1e-3, total_steps=steps, mesh=mesh, t_max=t_max,
                          ring=ring, remat=remat, use_pallas=use_pallas, fused_mlp=fused_mlp)
    local = tmesh.shard_tree(params, tmesh.param_pspec_tree(params), mesh)
    lora, opt = trainer.init_state(torch.Generator().manual_seed(1))
    if lora_np is not None:
        lora = trainer.local_tree(bridge.to_torch(lora_np))
        opt = trainer.tx.init(lora)
    tokens, mask, pos = (torch.from_numpy(a) for a in (tb.tokens, tb.loss_mask, tb.answer_pos))
    lora, opt, log = trainer.fit(local, lora, opt, tokens, mask, batches, all_pos=pos,
                                 log_every=1)
    probs = score_heldout_mcq(local, lora, spec, lspec, tokens, pos, tb.option_token_ids,
                              tb.n_options, fold_id, k, batch=8, mesh=mesh)
    whole = trainer.global_tree(lora)
    return (np.asarray(log.fold_losses), probs,
            {p: {n: t.numpy() for n, t in ab.items()} for p, ab in whole.items()})


def train_rank(rank, world, configs):
    """:func:`train_one` for each config (keyword dicts) on this rank."""
    return [train_one(**cfg) for cfg in configs]


def cli_rank(rank, world, argvs):
    """``python -m tst_torch <argv>`` on this rank for each argv → the exit
    codes (rank 0 writes the artifacts)."""
    from tst_torch import cli

    return [cli.main(list(argv)) for argv in argvs]


def decode_one(shape, max_new=6, gamma=2):
    """Held-out greedy and speculative tokens of the tiny model (fold-stacked
    adapters of k=2 with random B; the draft is the base) under the mesh
    ``shape`` → [greedy [k, M, max_new], speculative]. One rank runs in the
    calling process."""
    from tst_torch.models.lora import LoraSpec, init_lora
    from tst_torch.runtime import mesh as tmesh
    from tst_torch.train.infer import _decode_heldout_rows

    mesh = tmesh.make_mesh(fold=shape[0], data=shape[1], seq=shape[2], tensor=shape[3])
    spec, params, tb, fold_id = _tiny_setup(k=2)
    g = torch.Generator().manual_seed(3)
    lspec = LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
    loras = [init_lora(g, spec, lspec) for _ in range(2)]
    for lo in loras:
        for ab in lo.values():
            ab["b"] = 0.1 * torch.randn(ab["b"].shape, generator=g)
    lora = {p: {n: torch.stack([lo[p][n] for lo in loras]) for n in ("a", "b")}
            for p in loras[0]}
    local = tmesh.shard_tree(params, tmesh.param_pspec_tree(params), mesh)
    lora_local = tmesh.local_lora(lora, mesh)
    tokens, pos = torch.from_numpy(tb.tokens), torch.from_numpy(tb.answer_pos)
    rows = np.arange(tb.n)
    return [_decode_heldout_rows(local, lora_local, spec, lspec, tokens, pos, rows, fold_id, 2,
                                 max_new, False, chunk=4, draft=draft, gamma=gamma,
                                 mesh=mesh)[0]
            for draft in (None, (spec, local))]


def decode_rank(rank, world, shapes):
    return [decode_one(shape) for shape in shapes]


def packed_one(shape, params_np, lora_np, steps=2, pack_len=256):
    """Packed FoldTrainer steps (k=2, the tiny spec in f32, 2 packed rows of
    ``pack_len`` a fold a step) from the given weights and initial adapters
    (numpy trees), then the held-out MCQ scorer with the trained adapters,
    on the mesh ``shape`` → (per-fold losses [steps, k], probabilities
    [N, C])."""
    from tst_torch import bridge
    from tst_torch.data.packing import make_packed_fold_batches, pack_fold_datasets
    from tst_torch.models.lora import LoraSpec
    from tst_torch.runtime import mesh as tmesh
    from tst_torch.train.infer import score_heldout_mcq
    from tst_torch.train.sft import FoldTrainer

    mesh = tmesh.make_mesh(fold=shape[0], data=shape[1], seq=shape[2], tensor=shape[3])
    spec, _, tb, fold_id = _tiny_setup(k=2)
    fp = pack_fold_datasets(tb, fold_id, 2, pack_len)
    batches = make_packed_fold_batches(fp.n_rows, 2, 1, seed=0,
                                       batch_multiple=shape[1])[:steps]
    lspec = LoraSpec(rank=4, alpha=8.0, dtype=torch.float32)
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    trainer = FoldTrainer(spec, lspec, 2, lr=1e-3, total_steps=steps, mesh=mesh, t_max=t_max,
                          packed=True)
    params = bridge.to_torch(params_np)
    local = tmesh.shard_tree(params, tmesh.param_pspec_tree(params), mesh)
    lora = trainer.local_tree(bridge.to_torch(lora_np))
    ptok, pmask, ppos, psegs = (torch.from_numpy(a) for a in (fp.tokens, fp.loss_mask,
                                                             fp.answer_pos, fp.seg_starts))
    lora, _, log = trainer.fit(local, lora, trainer.tx.init(lora), ptok, pmask, batches,
                               all_pos=ppos, all_segs=psegs, n_segs=fp.n_segs, log_every=1)
    probs = score_heldout_mcq(local, lora, spec, lspec, torch.from_numpy(tb.tokens),
                              torch.from_numpy(tb.answer_pos), tb.option_token_ids,
                              tb.n_options, fold_id, 2, batch=8, mesh=mesh)
    return np.asarray(log.fold_losses), probs


def dry_mesh_rank(rank, world, shape, params_np, lora_np):
    """On the dry run's mesh ``shape``: :func:`packed_one` from the given
    weights and adapters, :func:`train_one` with the ring, and
    :func:`decode_one` → their three results."""
    return (packed_one(shape, params_np, lora_np), train_one(shape, ring=True),
            decode_one(shape))
