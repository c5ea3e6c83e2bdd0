"""Ring attention: causal attention with the sequence split over the ranks of
a mesh axis (counterpart of ``tst/kernels/ring_attention.py``).

The reference is plain ``jnp`` under ``shard_map`` (no ``pallas_call``); the
port is torch with point-to-point transfers:

  * each rank keeps its Q block and computes partial attention against the
    K/V block it holds: (o, lse), lse = -inf where a query sees no key of
    the block;
  * the partials merge by their logsumexps (:func:`_combine`), as flash
    attention merges its tiles;
  * K/V blocks rotate one rank around the ring between steps (the
    reference's ``ppermute``; here ``batch_isend_irecv``), so after n steps
    each rank has seen every block;
  * the backward runs the same ring: dQ stays with its rank, dK and dV
    travel with their block, summed at each rank it visits, and reach the
    owner with the block's last rotation (the counterpart of autodiff
    through ``ppermute``).

The rank's step is :func:`ring_forward` / :func:`ring_backward` over a list
of blocks and a ``rotate`` function: on a mesh the list holds this rank's
block and ``rotate`` sends it to the next rank; ``local_rotate`` runs all n
ranks' blocks in one process (chip_smoke.py holds that against the flash
kernel at S=16384). Queries and keys carry their global positions, so
causal masking is offset-aware: a block wholly in the future contributes
nothing.

Two routes for a pair's partial and its gradients, chosen by ``use_pallas``
(the decoder's own flag), never by dtype or shape:

  * plain (``use_pallas=False``): the reference's arithmetic in f32 torch,
    :func:`_online_partial` (chunked online softmax) and
    :func:`_pair_backward`, held to the JAX package;
  * kernels (``use_pallas=True``): K1 (tst_torch.kernels.flash_attention),
    the CUDA kernels for CUDA tensors (bf16, S_local a multiple of 64, D 64
    or 128, the default scale; anything else raises) and their plain
    versions for CPU tensors. Under ``causal`` the diagonal block (the
    rank's own) is K1 causal, a past block K1 non-causal, and a future
    block is skipped: its partial has lse = -inf, which :func:`_combine`
    leaves out exactly, and its probabilities are all 0. Without
    ``causal`` every block is K1 non-causal. The backward passes K1 the
    combined rows' lse and di = Σ o·do, as :func:`_pair_backward` uses them.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tst_torch.kernels.flash_attention import (attention_backward_reference, flash_attention,
                                              flash_attention_backward, flash_attention_fwd)

NEG_INF = -1e30

Blocks = List[Tuple[torch.Tensor, ...]]


def _online_partial(q, k, v, q_off: int, kv_off: int, causal: bool, sm_scale: float,
                    chunk: int = 512):
    """Partial attention of Q against one K/V block. q [B, Sq, H, D]; k, v
    [B, Skv, KVH, D]; offsets: global positions of element 0 → (o [B, Sq,
    H, D] f32, normalized within this block; lse [B, Sq, H] f32, NEG_INF
    where fully masked). Keys go in chunks of ``chunk`` with an online
    softmax, so no [Sq, Skv] tensor outgrows one chunk."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, skv)
    if skv % chunk:
        raise ValueError(f"{skv} keys do not split into chunks of {chunk}")
    qg = q.reshape(b, sq, kvh, g, d)
    q_pos = q_off + torch.arange(sq, device=q.device)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32, device=q.device)
    for c0 in range(0, skv, chunk):
        ks, vs = k[:, c0: c0 + chunk], v[:, c0: c0 + chunk]
        s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(), ks.float()) * sm_scale
        if causal:
            kv_pos = kv_off + c0 + torch.arange(chunk, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]  # [Sq, chunk]
            s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
        m_next = torch.maximum(m, s.amax(-1))
        # fully masked rows keep m at NEG_INF: shift against a safe max
        safe_m = torch.clamp_min(m_next, NEG_INF + 1.0)
        alpha = torch.exp(torch.clamp_max(m - safe_m, 0.0)) * (m > NEG_INF / 2)
        p = torch.exp(s - safe_m[..., None]) * (s > NEG_INF / 2)
        l = alpha * l + p.sum(-1)
        pv = torch.einsum("bqkgs,bskd->bqkgd", p.to(v.dtype).float(), vs.float())
        acc = acc * alpha[..., None] + pv
        m = m_next
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = (acc / l_safe[..., None]).reshape(b, sq, h, d)
    lse = torch.where(l > 0.0, m + torch.log(l_safe), torch.full_like(l, NEG_INF))
    return o, lse.reshape(b, sq, h)


def _combine(o_a, lse_a, o_b, lse_b):
    """Merge two normalized partials by their logsumexps."""
    m = torch.maximum(lse_a, lse_b)
    safe_m = torch.clamp_min(m, NEG_INF + 1.0)
    wa = torch.exp(torch.clamp_max(lse_a - safe_m, 0.0)) * (lse_a > NEG_INF / 2)
    wb = torch.exp(torch.clamp_max(lse_b - safe_m, 0.0)) * (lse_b > NEG_INF / 2)
    denom = wa + wb
    safe = torch.where(denom == 0.0, torch.ones_like(denom), denom)
    o = (o_a * wa[..., None] + o_b * wb[..., None]) / safe[..., None]
    lse = torch.where(denom > 0.0, safe_m + torch.log(safe), torch.full_like(denom, NEG_INF))
    return o, lse


def _pair_backward(q, k, v, do, lse, di, q_off: int, kv_off: int, causal: bool,
                   sm_scale: float, chunk: int):
    """The gradients one (Q block, K/V block) pair adds: (dq, dk, dv) in f32,
    from the probabilities exp(s - lse) of the whole row (``lse`` the
    combined forward's) and di = Σ o·do."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    chunk = min(chunk, skv)
    qg = q.reshape(b, sq, kvh, g, d).float()
    dog = do.reshape(b, sq, kvh, g, d).float()
    lse_g = lse.reshape(b, sq, kvh, g)
    di_g = di.reshape(b, sq, kvh, g)
    q_pos = q_off + torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for c0 in range(0, skv, chunk):
        ks, vs = k[:, c0: c0 + chunk].float(), v[:, c0: c0 + chunk].float()
        s = torch.einsum("bqkgd,bskd->bqkgs", qg, ks) * sm_scale
        if causal:  # masked before the exponential: a future key's exp(s - lse) may overflow
            kv_pos = kv_off + c0 + torch.arange(chunk, device=q.device)
            mask = kv_pos[None, :] <= q_pos[:, None]
            s = torch.where(mask[None, :, None, None, :], s, torch.full_like(s, NEG_INF))
        p = torch.exp(s - lse_g[..., None]) * (lse_g[..., None] > NEG_INF / 2)
        dvs.append(torch.einsum("bqkgs,bqkgd->bskd", p, dog))
        dp = torch.einsum("bqkgd,bskd->bqkgs", dog, vs)
        ds = p * (dp - di_g[..., None])
        dq += torch.einsum("bqkgs,bskd->bqkgd", ds, ks) * sm_scale
        dks.append(torch.einsum("bqkgs,bqkgd->bskd", ds, qg) * sm_scale)
    return dq.reshape(b, sq, h, d), torch.cat(dks, 1), torch.cat(dvs, 1)


def k1_causal(idx: int, src: int, causal: bool) -> Optional[bool]:
    """K1's ``causal`` for the Q block of rank ``idx`` against the K/V block
    of rank ``src`` (equal blocks): True on the diagonal, False for a past
    block or without ``causal``, None for a block wholly in the future (it
    adds nothing: skipped)."""
    if not causal or src < idx:
        return False
    return True if src == idx else None


def _k1_partial(q, k, v, idx: int, src: int, causal: bool):
    """One pair's partial through K1's forward → (o f32 [B, Sq, H, D], lse
    [B, Sq, H] f32), or None for a future block."""
    mode = k1_causal(idx, src, causal)
    if mode is None:
        return None
    o, lse = flash_attention_fwd(q, k.contiguous(), v.contiguous(), mode, None)
    return o.float(), lse.transpose(1, 2)


def _k1_pair_backward(q, k, v, do, lse, di, idx: int, src: int, causal: bool):
    """One pair's (dq, dk, dv) through K1's backward from the combined rows'
    ``lse`` and ``di`` (f32 [B, H, Sq]), or None for a future block."""
    mode = k1_causal(idx, src, causal)
    if mode is None:
        return None
    backward = (attention_backward_reference if q.device.type == "cpu"
                else flash_attention_backward)
    return backward(q, k.contiguous(), v.contiguous(), lse, di, do, mode)


def _check_k1_scale(q: torch.Tensor, sm_scale: float) -> None:
    if sm_scale != 1.0 / math.sqrt(q.shape[-1]):
        raise ValueError(f"the ring's kernel route takes the default scale 1/sqrt(D), got "
                         f"sm_scale={sm_scale}")


def ring_forward(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                 vs: Sequence[torch.Tensor], idxs: Sequence[int], n: int,
                 rotate: Callable[[Blocks], Blocks], causal: bool, sm_scale: float,
                 chunk: int, use_pallas: bool = False):
    """The ranks' forward steps: for each held Q block (rank ``idxs[j]`` of
    ``n``, ``s_local`` positions), partial attention against the K/V block
    in hand (K1 with ``use_pallas``, else the plain partial), combined, then
    the K/V blocks rotated; n steps. → ([o f32], [lse])."""
    s_local = qs[0].shape[1]
    if use_pallas:
        _check_k1_scale(qs[0], sm_scale)
        qs = [q.contiguous() for q in qs]
    held: Blocks = [(k, v) for k, v in zip(ks, vs)]
    os_ = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    lses = [torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=q.device) for q in qs]
    for i in range(n):
        for j, (q, idx) in enumerate(zip(qs, idxs)):
            src = (idx - i) % n  # the rank this K/V block belongs to
            kb, vb = held[j]
            if use_pallas:
                part = _k1_partial(q, kb, vb, idx, src, causal)
            else:
                part = _online_partial(q, kb, vb, idx * s_local, src * s_local, causal,
                                       sm_scale, chunk)
            if part is not None:
                os_[j], lses[j] = _combine(os_[j], lses[j], *part)
        if i < n - 1:
            held = rotate(held)
    return os_, lses


def ring_backward(qs, ks, vs, os_, lses, dos, idxs: Sequence[int], n: int,
                  rotate: Callable[[Blocks], Blocks], causal: bool, sm_scale: float,
                  chunk: int, use_pallas: bool = False):
    """The reverse ring: each K/V block travels with its dK and dV, each rank
    adds its pair's share (K1's backward with ``use_pallas``, else the plain
    pair backward), and the block's n-th rotation brings the sums home. →
    ([dq], [dk], [dv]) in f32, each on its owner."""
    s_local = qs[0].shape[1]
    dis = [(do.float() * o).sum(-1) for do, o in zip(dos, os_)]
    if use_pallas:  # K1 takes the row statistics as [B, H, S]
        qs = [q.contiguous() for q in qs]
        dos = [do.contiguous() for do in dos]
        stats = [(lse.transpose(1, 2).contiguous(), di.transpose(1, 2).contiguous())
                 for lse, di in zip(lses, dis)]
    dqs = [torch.zeros(q.shape, dtype=torch.float32, device=q.device) for q in qs]
    held: Blocks = [(k, v, torch.zeros(k.shape, dtype=torch.float32, device=k.device),
                     torch.zeros(v.shape, dtype=torch.float32, device=v.device))
                    for k, v in zip(ks, vs)]
    for i in range(n):
        for j, (q, idx) in enumerate(zip(qs, idxs)):
            src = (idx - i) % n
            kb, vb, dkb, dvb = held[j]
            if use_pallas:
                grads = _k1_pair_backward(q, kb, vb, dos[j], *stats[j], idx, src, causal)
            else:
                grads = _pair_backward(q, kb, vb, dos[j], lses[j], dis[j], idx * s_local,
                                       src * s_local, causal, sm_scale, chunk)
            if grads is None:
                continue
            dq, dk, dv = grads
            dqs[j] += dq
            held[j] = (kb, vb, dkb + dk, dvb + dv)
        # the last rotation takes each block and its sums back to the owner
        held = rotate(held)
    return dqs, [h[2] for h in held], [h[3] for h in held]


def local_rotate(blocks: Blocks) -> Blocks:
    """All ranks' blocks in one process: rank r receives rank r - 1's."""
    return [blocks[-1]] + list(blocks[:-1])


def p2p_rotate(group) -> Callable[[Blocks], Blocks]:
    """This rank's block to the next rank of ``group``, the previous rank's
    block received (``batch_isend_irecv``; collective 9 of
    tst_torch.runtime.mesh)."""
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prv = dist.get_global_rank(group, (me - 1) % n)

    def rotate(blocks: Blocks) -> Blocks:
        (tensors,) = blocks
        got = [torch.empty_like(t) for t in tensors]
        ops = []
        for t, r in zip(tensors, got):
            ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
            ops.append(dist.P2POp(dist.irecv, r, prv, group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [tuple(got)]

    return rotate


class _Ring(torch.autograd.Function):
    """Ring attention over the blocks ``qkv`` (m Q blocks, then m K, m V):
    its backward is :func:`ring_backward` on the same rotation and route."""

    @staticmethod
    def forward(ctx, rotate, idxs, n, causal, sm_scale, chunk, use_pallas, *qkv):
        m = len(idxs)
        qs, ks, vs = qkv[:m], qkv[m: 2 * m], qkv[2 * m:]
        with torch.no_grad():
            os_, lses = ring_forward(qs, ks, vs, idxs, n, rotate, causal, sm_scale, chunk,
                                     use_pallas)
        ctx.rotate, ctx.idxs, ctx.n, ctx.causal, ctx.scale, ctx.chunk, ctx.use_pallas = (
            rotate, idxs, n, causal, sm_scale, chunk, use_pallas)
        ctx.save_for_backward(*qkv, *os_, *lses)
        return tuple(o.to(q.dtype) for o, q in zip(os_, qs))

    @staticmethod
    def backward(ctx, *dos):
        m = len(ctx.idxs)
        saved = ctx.saved_tensors
        qs, ks, vs = saved[:m], saved[m: 2 * m], saved[2 * m: 3 * m]
        os_, lses = saved[3 * m: 4 * m], saved[4 * m:]
        with torch.no_grad():
            dqs, dks, dvs = ring_backward(qs, ks, vs, os_, lses, dos, ctx.idxs, ctx.n,
                                          ctx.rotate, ctx.causal, ctx.scale, ctx.chunk,
                                          ctx.use_pallas)
        grads = ([dq.to(q.dtype) for dq, q in zip(dqs, qs)]
                 + [dk.to(k.dtype) for dk, k in zip(dks, ks)]
                 + [dv.to(v.dtype) for dv, v in zip(dvs, vs)])
        return (None,) * 7 + tuple(grads)


def ring_blocks(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                vs: Sequence[torch.Tensor], idxs: Sequence[int], n: int,
                rotate: Callable[[Blocks], Blocks], causal: bool = True,
                sm_scale: Optional[float] = None, chunk: int = 512,
                use_pallas: bool = False) -> Tuple[torch.Tensor, ...]:
    """Ring attention of the Q blocks ``qs`` (ranks ``idxs`` of ``n``)
    against every rank's K/V, differentiable: ``rotate`` moves the blocks
    (``p2p_rotate`` on a mesh, ``local_rotate`` for all ranks in one
    process); ``use_pallas`` takes each pair through K1. → the output
    blocks in q's dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(qs[0].shape[-1]))
    return _Ring.apply(rotate, tuple(idxs), n, causal, scale, chunk, use_pallas, *qs, *ks, *vs)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   seq_axis: str = "seq", causal: bool = True,
                   sm_scale: Optional[float] = None, chunk: int = 512,
                   use_pallas: bool = False) -> torch.Tensor:
    """Sequence-parallel attention over ``mesh``'s ``seq_axis``: q [B,
    S_local, H, D] is this rank's block (rank i holds positions [i·S_local,
    (i+1)·S_local)), k and v [B, S_local, KVH, D] likewise; the result
    matches unsplit attention. One rank on the axis: one partial (K1 with
    ``use_pallas``)."""
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / float(np.sqrt(d))
    n = 1 if mesh is None else mesh.size(seq_axis)
    if n == 1:
        if use_pallas:
            _check_k1_scale(q, scale)
            return flash_attention(q, k, v, causal)[0]
        o, _ = _online_partial(q, k, v, 0, 0, causal, scale, chunk)
        return o.to(q.dtype)
    rotate = p2p_rotate(mesh.group(seq_axis))
    return ring_blocks([q], [k], [v], [mesh.index(seq_axis)], n, rotate, causal, scale,
                       chunk, use_pallas)[0]
