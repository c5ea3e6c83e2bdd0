"""Fold-parallel blind LoRA SFT (counterpart of ``tst/train/sft.py``).

All k fold-models train at once as one program: the frozen base is one copy,
the LoRA adapters and their AdamW moments carry a leading ``[k]`` fold axis,
and one step gathers the batch ``[k, B, S]`` from the device-resident
dataset by index, runs one forward and one backward over the ``k·B``
fold-major rows, and updates every fold. The loss is the sum of the per-fold
masked means, so each fold's adapter gets its own gradient. Fold f trains
only on rows whose fold id is not f (``make_fold_batches``). Packed
training (``packed=True``, tst_torch.data.packing) gathers each fold's rows
from its own packed split ``[k, Np, L]``, with segment starts.

The loss is cross-entropy on the answer tokens only, in f32 off bf16
activations; AdamW with a warmup-cosine schedule mirrors optax's
``adamw(warmup_cosine_decay_schedule(...))`` step for step. With
``lora.dropout > 0`` each step drops the adapters' inputs with masks drawn
from (fold, optimizer step, layer, projection) (tst_torch.models.lora).
``fit`` checkpoints the adapters and the optimizer state
(tst_torch.aux.ckpt) and resumes from the last checkpoint.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tst_torch.aux import ckpt as ckpt_mod
from tst_torch.aux.profile import span
from tst_torch.models.decoder import apply_model, check_remat, check_tensor_widths, head_logits
from tst_torch.runtime import mesh as mesh_mod
from tst_torch.models.lora import DropoutKey, LoraSpec, MaskFn, dropout_mask, fold_count, init_lora
from tst_torch.models.spec import ModelSpec

Params = Dict[str, Any]


#: raise at the first non-finite loss or adapter gradient (``--debug-nans``)
DEBUG_NANS = False


def set_debug_nans(on: bool) -> None:
    """Turn the train step's finite check on or off for the process: the
    counterpart of ``jax.config.update("jax_debug_nans", ...)``."""
    global DEBUG_NANS
    DEBUG_NANS = bool(on)


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise to nested dicts of tensors of one structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in tree}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    return [tree]


def check_finite(losses: torch.Tensor, grads: Params, step: int, fold0: int = 0) -> None:
    """Raise FloatingPointError naming the step and the first fold whose loss
    or adapter gradient holds a NaN or an infinity (gradient leaves
    fold-stacked; folds counted from ``fold0``, a rank's first fold)."""
    bad_loss = ~torch.isfinite(losses.detach().float())
    bad = bad_loss.clone()
    for g in tree_leaves(grads):
        bad |= ~torch.isfinite(g.float()).reshape(g.shape[0], -1).all(-1)
    if bool(bad.any()):
        f = int(bad.nonzero()[0, 0])
        what = "loss" if bool(bad_loss[f]) else "adapter gradient"
        raise FloatingPointError(f"non-finite {what} at step {step}, fold {fold0 + f} "
                                 "(--debug-nans)")


def _masked_mean(logits: torch.Tensor, labels: torch.Tensor, w: torch.Tensor,
                 n_folds: Optional[int], mesh=None) -> torch.Tensor:
    """-Σ w·log p(label) / max(Σ w, 1): a scalar, or with ``n_folds`` the
    [k] per-fold means over the fold-major row blocks. Under a mesh whose
    ``data`` axis splits the rows, Σ w is the sum over the axis, so the
    ranks' results add up to the one-process mean (their gradients are
    summed over the axis)."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    gold = lp.gather(-1, labels.long()[..., None])[..., 0]
    k = n_folds or 1
    nll = -(gold * w).reshape(k, -1).sum(-1)
    loss = nll / mesh_mod.sum_over(w.reshape(k, -1).sum(-1), mesh, ["data"]).clamp_min(1.0)
    return loss if n_folds else loss[0]


def sft_loss(
    base: Params,
    lora: Params,
    tokens: torch.Tensor,  # int [B, S]
    loss_mask: torch.Tensor,  # f32 [B, S] — 1.0 on target tokens
    spec: ModelSpec,
    lora_spec: LoraSpec,
    use_pallas: bool = False,
    remat: bool = False,
    ring_mesh=None,
    fused_mlp: bool = False,
    lora_rng=None,
    seg_starts=None,
    mesh=None,
) -> torch.Tensor:
    """Prompt-masked causal-LM cross entropy (mean over target tokens). With
    a fold-stacked ``lora`` and fold-major rows, the [k] per-fold means.
    ``mesh``: the base and adapters are this rank's shards (apply_model)."""
    logits = apply_model(base, tokens, spec, lora=lora, lora_spec=lora_spec,
                         use_pallas=use_pallas, remat=remat, ring_mesh=ring_mesh,
                         fused_mlp=fused_mlp, lora_rng=lora_rng,
                         seg_starts=seg_starts, mesh=mesh)  # [B, S, V] f32
    return _masked_mean(logits[:, :-1], tokens[:, 1:], loss_mask[:, 1:], fold_count(lora),
                        mesh)


def sft_loss_window(
    base: Params,
    lora: Params,
    tokens: torch.Tensor,  # int [B, S]
    loss_mask: torch.Tensor,  # f32 [B, S]
    answer_pos: torch.Tensor,  # int [B] or [B, G] — last prompt-token index
    t_max: int,  # max target length in tokens
    spec: ModelSpec,
    lora_spec: LoraSpec,
    use_pallas: bool = False,
    remat: bool = False,
    ring_mesh=None,
    fused_mlp: bool = False,
    lora_rng=None,
    seg_starts=None,
    mesh=None,
) -> torch.Tensor:
    """The loss of :func:`sft_loss`, with the vocabulary projection only on
    the ``t_max`` rows ``answer_pos + [0, t_max)`` (targets are contiguous
    from ``answer_pos + 1``; loss_mask is zero elsewhere). Logits are f32
    products of the bf16 hidden rows and head.

    Packed rows: ``seg_starts`` [B, n] and a 2-D ``answer_pos`` [B, G], one
    window per packed sample (-1 on unused slots, whose windows weigh 0).
    A window stops before the next segment's start, so a long ``t_max``
    never counts the next sample's first tokens."""
    h = apply_model(base, tokens, spec, lora=lora, lora_spec=lora_spec,
                    use_pallas=use_pallas, remat=remat, return_hidden=True,
                    ring_mesh=ring_mesh, fused_mlp=fused_mlp, lora_rng=lora_rng,
                    seg_starts=seg_starts, mesh=mesh)  # [B, S, D]
    b, s = tokens.shape
    ap = (answer_pos if answer_pos.ndim == 2 else answer_pos[:, None]).long()  # [B, G]
    g = ap.shape[1]
    start = ap.clamp_min(0)
    rows = start[:, :, None] + torch.arange(t_max, device=h.device)[None, None, :]  # [B, G, T]
    in_range = (rows <= s - 2) & (ap >= 0)[:, :, None]
    if seg_starts is not None:
        seg = torch.as_tensor(seg_starts, device=h.device).long()[:, None, :]  # [B, 1, n]
        seg_end = torch.where(seg > start[:, :, None], seg, s).amin(-1)  # [B, G]: next start
        in_range = in_range & (rows + 1 < seg_end[:, :, None])
    rows = rows.reshape(b, g * t_max).clamp_max(s - 2)
    hsel = h.gather(1, rows[..., None].expand(-1, -1, h.shape[-1]))  # [B, G·T, D]
    logits = head_logits(hsel, base, spec, mesh=mesh)
    labels = tokens.gather(1, rows + 1)
    w = loss_mask.gather(1, rows + 1) * in_range.reshape(b, g * t_max)
    return _masked_mean(logits, labels, w, fold_count(lora), mesh)


def warmup_cosine_schedule(lr: float, total_steps: int,
                           warmup_frac: float = 0.03) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps=max(int(total·frac), 1), decay_steps=max(total, warmup+1),
    end_value=0.05·lr): the lr of update ``count`` (0 at the first)."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay = max(total_steps, warmup + 1) - warmup
    alpha = 0.05

    def sched(count: int) -> float:
        if count < warmup:
            return lr * count / warmup
        t = min(count - warmup, decay)
        return lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return sched


@dataclasses.dataclass
class AdamWState:
    count: int
    mu: Params
    nu: Params


class AdamW:
    """optax.adamw (eps 1e-8, decoupled weight decay) on adapter trees, in
    optax's order of operations. The moments keep the adapter's dtype, as
    optax's do; leaves may be fold-stacked (the update is elementwise, so
    each fold steps on its own)."""

    def __init__(self, sched: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        self.sched, self.b1, self.b2, self.eps, self.wd = sched, b1, b2, eps, weight_decay

    def init(self, params: Params) -> AdamWState:
        zeros = tree_map(torch.zeros_like, params)
        return AdamWState(0, zeros, tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState,
               params: Params) -> Tuple[Params, AdamWState]:
        """(updates, new state); apply with :func:`apply_updates`."""
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, state.mu)
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, state.nu)
        count = state.count + 1
        # bias corrections in f32, then in the moment's dtype (optax's)
        bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
        lr = -self.sched(state.count)

        def one(m, v, p):
            u = (m / torch.tensor(bc1, dtype=m.dtype)) / (
                torch.sqrt(v / torch.tensor(bc2, dtype=v.dtype)) + self.eps)
            if self.wd:
                u = u + self.wd * p
            return torch.tensor(lr, dtype=u.dtype) * u

        return tree_map(one, mu, nu, params), AdamWState(count, mu, nu)


def apply_updates(params: Params, updates: Params) -> Params:
    """optax.apply_updates: (p + u) in p's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_optimizer(lr: float, total_steps: int, warmup_frac: float = 0.03,
                   weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999) -> AdamW:
    return AdamW(warmup_cosine_schedule(lr, total_steps, warmup_frac), b1=b1, b2=b2,
                 weight_decay=weight_decay)


def make_fold_batches(
    fold_id: np.ndarray,
    k: int,
    batch_size: int,
    epochs: int,
    seed: int,
    batch_multiple: int = 1,
    include_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Per-fold epoch index streams: int32 [total_steps, k, B] (a copy of the
    reference's numpy function, whose module imports jax).

    Fold f trains on rows with ``fold_id != f``. Every fold runs the same
    number of steps, so steps_per_epoch is set by the largest train split;
    smaller splits wrap around (a fresh permutation per wrap). ``batch_size``
    is rounded up to ``batch_multiple``. ``include_mask`` (bool [N])
    restricts training to a subset."""
    b = batch_size + (-batch_size) % batch_multiple
    rng = np.random.default_rng(seed)
    keep = np.ones_like(fold_id, bool) if include_mask is None else np.asarray(include_mask, bool)
    train_rows: List[np.ndarray] = [
        np.flatnonzero((fold_id != f) & keep) for f in range(k)
    ]
    for f, rows in enumerate(train_rows):
        if len(rows) == 0:
            raise ValueError(f"fold {f} has an empty train split")
    steps_per_epoch = max(int(np.ceil(len(r) / b)) for r in train_rows)
    total = steps_per_epoch * epochs
    out = np.zeros((total, k, b), np.int32)
    for f, rows in enumerate(train_rows):
        stream = []
        while len(stream) < total * b:
            stream.extend(rng.permutation(rows).tolist())
        out[:, f, :] = np.asarray(stream[: total * b], np.int32).reshape(total, b)
    return out


@dataclasses.dataclass
class TrainLog:
    losses: List[float] = dataclasses.field(default_factory=list)  # mean over folds
    fold_losses: List[List[float]] = dataclasses.field(default_factory=list)
    steps: int = 0
    wall_seconds: float = 0.0
    samples_per_sec: float = 0.0
    #: wall of the first step of each fit call, synchronized
    first_step_seconds: float = 0.0


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class FoldTrainer:
    """The fold-parallel train step and the training loop.

    ``mesh`` (tst_torch.runtime.mesh): the base passed to :meth:`step` and
    :meth:`fit` is this rank's shard (``shard_tree``), and the adapters and
    AdamW moments are this rank's part (:meth:`init_state`): its block of
    k / fold folds, B split over ``tensor`` on the column-parallel
    projections. Each rank gathers its folds' rows of a batch and its share
    of them over ``data``; the window loss's sums run over ``data``, so the
    per-fold losses are the one-process numbers on every rank, and the
    gradients are summed over ``data`` (and ``seq`` under the ring, and
    ``tensor`` where a rank holds a whole leaf). ``ring``: attention goes
    around the mesh's ``seq`` axis (each rank runs its sequence block).
    Checkpoints gather to rank 0 on save and every rank reads its part on
    load; the file is the one-process file."""

    def __init__(
        self,
        spec: ModelSpec,
        lora_spec: LoraSpec,
        k: int,
        lr: float = 1e-4,
        total_steps: int = 100,
        warmup_frac: float = 0.03,
        weight_decay: float = 0.0,
        use_pallas: bool = False,
        remat: bool = False,
        mesh=None,
        t_max: Optional[int] = None,
        ring: bool = False,
        b1: float = 0.9,
        b2: float = 0.999,
        fused_mlp: bool = False,
        packed: bool = False,
        dropout_masks: MaskFn = dropout_mask,
    ):
        check_remat(remat)
        self.mesh = mesh if mesh_mod.active(mesh) else None
        #: sequence-parallel training: ring attention over the mesh's "seq" axis
        self.ring_mesh = self.mesh if (ring and self.mesh is not None
                                       and self.mesh.size("seq") > 1) else None
        #: the folds this rank steps
        self.folds = mesh_mod.fold_range(k, self.mesh)
        if self.mesh is not None:
            check_tensor_widths(spec, self.mesh.size("tensor"))
        self.spec = spec
        self.lora_spec = lora_spec
        self.k = k
        self.tx = make_optimizer(lr, total_steps, warmup_frac, weight_decay, b1, b2)
        self.use_pallas = use_pallas
        #: recompute each layer in the backward (tst_torch.models.decoder)
        self.remat = remat
        #: the fused SwiGLU MLP kernel (with use_pallas, no adapter on the MLP)
        self.fused_mlp = fused_mlp
        #: answer-window length; None = full-sequence loss
        self.t_max = t_max
        #: packed rows (tst_torch.data.packing): ``step``/``fit`` take per-fold
        #: arrays [k, Np, ...] with segment starts, and answer_pos [k, Np, G]
        self.packed = packed
        #: draws one fold block's LoRA dropout mask (with lora_spec.dropout >
        #: 0); the parity tests inject the reference's masks here
        self.dropout_masks = dropout_masks

    def ckpt_extra(self, **kw) -> Dict[str, Any]:
        """Host metadata for a checkpoint's extra.json: k and the LoRA
        geometry, so serving can rebuild the adapter tree."""
        return {
            "k": self.k,
            "model_name": self.spec.name,
            "lora_rank": self.lora_spec.rank,
            "lora_alpha": self.lora_spec.alpha,
            "lora_targets": list(self.lora_spec.targets),
            **kw,
        }

    def init_state(self, rng: torch.Generator) -> Tuple[Params, AdamWState]:
        """(fold-stacked adapters [k, ...], optimizer state). The k adapters
        are consecutive draws of ``rng``, so the folds start decorrelated;
        under a mesh, this rank's part of them."""
        loras = [init_lora(rng, self.spec, self.lora_spec) for _ in range(self.k)]
        lora = mesh_mod.local_lora(tree_map(lambda *xs: torch.stack(xs), *loras), self.mesh)
        return lora, self.tx.init(lora)

    def global_tree(self, tree: Params) -> Params:
        """A rank's adapter-shaped tree (adapters, or an AdamW moment) made
        whole: every fold, B unsplit; a collective, every rank calls it."""
        if self.mesh is None:
            return tree
        return {p: {n: mesh_mod.gather_leaf(t, mesh_mod.lora_local_pspec(p, n), self.mesh)
                    for n, t in ab.items()} for p, ab in tree.items()}

    def local_tree(self, tree: Params) -> Params:
        """:meth:`global_tree`'s inverse: this rank's part of a whole tree."""
        return mesh_mod.local_lora(tree, self.mesh)

    def _rows(self, idx_kb: np.ndarray) -> np.ndarray:
        """This rank's part of a batch's [k, B] rows: its folds, its share
        over ``data``."""
        idx = np.asarray(idx_kb)[self.folds.start: self.folds.stop]
        if self.mesh is not None and self.mesh.size("data") > 1:
            n, i = self.mesh.size("data"), self.mesh.index("data")
            if idx.shape[1] % n:
                raise ValueError(f"batch of {idx.shape[1]} rows a fold does not split over the "
                                 f"{n} ranks of the 'data' axis (make_fold_batches' "
                                 "batch_multiple)")
            per = idx.shape[1] // n
            idx = idx[:, i * per: (i + 1) * per]
        return idx

    def loss_and_grads(self, base: Params, lora: Params, tokens: torch.Tensor,
                       mask: torch.Tensor, pos: torch.Tensor,
                       segs: Optional[torch.Tensor] = None,
                       step: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
        """Per-fold losses [k] and the adapters' gradients for one batch
        ``[k, B, S]`` (packed: ``pos`` and ``segs`` [k, B, G]): one forward
        and one backward over all folds. ``step`` (the optimizer's count)
        seeds the dropout masks when ``lora_spec.dropout > 0``; without it
        nothing is dropped."""
        k, b, s = tokens.shape
        lora_rng = None
        if step is not None and self.lora_spec.dropout > 0.0:
            rows = ((self.mesh.index("data"), self.mesh.size("data"))
                    if self.mesh is not None else None)
            lora_rng = DropoutKey(tuple(self.folds), int(step), self.dropout_masks, rows=rows)
        with span("train.forward"):
            params = tree_map(lambda t: t.detach().requires_grad_(True), lora)
            tokens, mask = tokens.reshape(k * b, s), mask.reshape(k * b, s)
            pos = pos.reshape(k * b, *pos.shape[2:])
            if segs is not None:
                segs = segs.reshape(k * b, -1)
            kw = dict(remat=self.remat, ring_mesh=self.ring_mesh, fused_mlp=self.fused_mlp,
                      lora_rng=lora_rng, seg_starts=segs, mesh=self.mesh)
            if self.t_max is None:
                losses = sft_loss(base, params, tokens, mask, self.spec, self.lora_spec,
                                  self.use_pallas, **kw)
            else:
                losses = sft_loss_window(base, params, tokens, mask, pos, self.t_max, self.spec,
                                         self.lora_spec, self.use_pallas, **kw)
        with span("train.backward"):
            leaves = tree_leaves(params)
            grads = torch.autograd.grad(losses.sum(), leaves)
            by_id = {id(leaf): g for leaf, g in zip(leaves, grads)}
            grads = mesh_mod.reduce_grads(tree_map(lambda t: by_id[id(t)], params), self.mesh,
                                          ring=self.ring_mesh is not None)
        return mesh_mod.sum_over(losses.detach(), self.mesh, ["data"]), grads

    def batch_loss_and_grads(self, base: Params, lora: Params, all_tokens: torch.Tensor,
                             all_mask: torch.Tensor, all_pos: torch.Tensor,
                             idx_kb: np.ndarray, all_segs: Optional[torch.Tensor] = None,
                             step: Optional[int] = None) -> Tuple[torch.Tensor, Params]:
        """:meth:`loss_and_grads` on rows ``idx_kb`` [k, B] of the whole
        arrays (:meth:`step`'s layout), gathered on the device: this rank's
        folds and share of the rows."""
        with span("train.rows"):
            rows = self._rows(idx_kb)
            # a copy from pageable memory: the host waits for the card's queue
            with span("train.rows.to_device", kind="wait", bytes=8 * rows.size):
                idx = torch.as_tensor(rows, dtype=torch.long).to(all_tokens.device)
            if self.packed:
                ka = torch.arange(self.folds.start, self.folds.stop, device=idx.device)[:, None]
                idx = (ka, idx)
            segs = None if all_segs is None else all_segs[idx]
            tokens, mask, pos = all_tokens[idx], all_mask[idx], all_pos[idx]
        return self.loss_and_grads(base, lora, tokens, mask, pos, segs, step=step)

    def step(self, base: Params, lora: Params, opt_state: AdamWState,
             all_tokens: torch.Tensor, all_mask: torch.Tensor, all_pos: torch.Tensor,
             idx_kb: np.ndarray, all_segs: Optional[torch.Tensor] = None,
             ) -> Tuple[Params, AdamWState, torch.Tensor]:
        """One fold-parallel step on rows ``idx_kb`` [k, B], gathered on the
        device → (adapters, optimizer state, per-fold losses [k]). Packed:
        the arrays are per fold ([k, Np, ...], ``all_segs`` the starts) and
        fold f's rows come from its own split. The dropout masks (with
        ``lora_spec.dropout > 0``) follow the optimizer's count, which the
        checkpoint restores. Under a mesh the step runs this rank's folds and
        rows, and the losses are this rank's folds'."""
        with span("train.step", unit=opt_state.count):
            losses, grads = self.batch_loss_and_grads(base, lora, all_tokens, all_mask, all_pos,
                                                      idx_kb, all_segs, step=opt_state.count)
            if DEBUG_NANS:
                check_finite(losses, grads, step=opt_state.count, fold0=self.folds.start)
            with span("train.optimizer"):
                updates, opt_state = self.tx.update(grads, opt_state, lora)
                lora = apply_updates(lora, updates)
        return lora, opt_state, losses

    def save(self, checkpoint_dir: str, lora: Params, opt_state: AdamWState,
             step: int) -> None:
        """A checkpoint of the whole adapters and AdamW state, written by rank
        0 (the other ranks wait for it)."""
        whole = (self.global_tree(lora), AdamWState(opt_state.count,
                                                     self.global_tree(opt_state.mu),
                                                     self.global_tree(opt_state.nu)))
        if mesh_mod.is_main():
            ckpt_mod.save_train_state(checkpoint_dir, *whole, extra=self.ckpt_extra(step=step))
        mesh_mod.barrier(self.mesh)

    def fit(
        self,
        base: Params,
        lora: Params,
        opt_state: AdamWState,
        all_tokens: torch.Tensor,
        all_mask: torch.Tensor,
        batches: np.ndarray,  # [steps, k, B]
        all_pos: Optional[torch.Tensor] = None,  # int [N]; required if t_max set
        log_every: int = 10,
        log_fn: Optional[Callable[[int, float], None]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50,
        fail_after_step: Optional[int] = None,  # fault injection for resume tests
        all_segs: Optional[torch.Tensor] = None,  # int32 [k, Np, MAX_SEGS] (packed)
        n_segs: Optional[np.ndarray] = None,  # int [k, Np] samples per row (packed)
    ) -> Tuple[Params, AdamWState, TrainLog]:
        """Run the steps of ``batches`` → (adapters, optimizer state, log).

        ``checkpoint_dir``: when it holds a checkpoint (its ``extra.json``),
        the adapters and optimizer state are restored from it and training
        resumes at its ``step``; a checkpoint is written every
        ``checkpoint_every`` steps and after the last. ``fail_after_step``
        raises after that step, its checkpoint written (fault injection).
        The log of a resumed fit holds the steps it ran."""
        if self.packed:
            if all_segs is None or all_pos is None:
                raise ValueError("packed mode needs all_segs and all_pos "
                                 "(tst_torch.data.packing.pack_fold_datasets arrays)")
        elif all_segs is not None:
            raise ValueError("all_segs passed to an unpacked FoldTrainer; "
                             "construct it with packed=True")
        if all_pos is None:
            if self.t_max is not None:
                raise ValueError("windowed loss (t_max set) needs all_pos")
            all_pos = torch.zeros(all_tokens.shape[0], dtype=torch.long,
                                  device=all_tokens.device)
        start_step = 0
        if checkpoint_dir is not None and os.path.exists(
                os.path.join(checkpoint_dir, ckpt_mod.EXTRA_FILE)):
            like = AdamWState(opt_state.count, self.global_tree(opt_state.mu),
                              self.global_tree(opt_state.nu))
            lora, opt_state, extra = ckpt_mod.load_train_state(
                checkpoint_dir, self.global_tree(lora), like)
            lora = self.local_tree(lora)
            opt_state = AdamWState(opt_state.count, self.local_tree(opt_state.mu),
                                   self.local_tree(opt_state.nu))
            start_step = int((extra or {}).get("step", 0))
        log = TrainLog()
        t0 = time.time()
        pending: List[torch.Tensor] = []
        for t in range(start_step, batches.shape[0]):
            lora, opt_state, loss = self.step(base, lora, opt_state, all_tokens, all_mask,
                                              all_pos, batches[t], all_segs)
            pending.append(mesh_mod.gather_folds(loss, self.mesh))
            if t == start_step:
                _sync(loss)
                log.first_step_seconds = time.time() - t0
            if (t + 1) % log_every == 0 or t == batches.shape[0] - 1:
                fold_loss = pending[-1].cpu().numpy()  # sync point
                mean = float(fold_loss.mean())
                log.losses.append(mean)
                log.fold_losses.append([float(x) for x in fold_loss])
                if log_fn:
                    log_fn(t + 1, mean)
                pending.clear()
            if checkpoint_dir is not None and (t + 1) % checkpoint_every == 0:
                self.save(checkpoint_dir, lora, opt_state, step=t + 1)
            if fail_after_step is not None and t + 1 >= fail_after_step:
                raise RuntimeError(f"injected failure after step {t + 1}")
        _sync(all_tokens)
        if checkpoint_dir is not None:
            self.save(checkpoint_dir, lora, opt_state, step=int(batches.shape[0]))
        log.steps = int(batches.shape[0])
        log.wall_seconds = time.time() - t0
        if self.packed and n_segs is not None:
            # real samples (segments), not packed rows
            n_samples = int(np.asarray(n_segs)[np.arange(batches.shape[1])[None, :, None],
                                               batches].sum())
        else:
            n_samples = int(np.prod(batches.shape))
        log.samples_per_sec = n_samples / max(log.wall_seconds, 1e-9)
        return lora, opt_state, log
