"""Meshes over several ranks, the sharding rules, and every collective the
port runs (counterpart of ``tst/runtime/mesh.py``).

The axes are the reference's, ``(fold, data, seq, tensor)``: ``fold`` the k
fold models (each rank steps only its folds), ``data`` the batch rows and
the FSDP shards of the frozen base, ``seq`` the ring-attention sequence
blocks, ``tensor`` Megatron-style tensor parallelism (local heads and ffn,
the vocabulary split). One process a rank, started by ``torchrun`` (one
rank a card) or by :func:`spawn_ranks`; NCCL carries CUDA tensors, gloo CPU
tensors. A mesh of one rank has no groups and no collective runs.

GSPMD inserted the reference's collectives implicitly. Here each is an
explicit ``torch.distributed`` call, written once, in this module:

  1. ``gather_data`` — the FSDP all-gather of a base leaf over ``data``
     along its ``embed`` dimension, one layer's leaf at a time, before its
     use; :func:`fsdp_apply` frees it after and gathers again in the
     backward;
  2. ``to_tensor`` — identity forward, all-reduce over ``tensor`` backward:
     the input of the column-parallel projections (q, k, v, gate, up) and of
     the vocabulary-split head;
  3. ``from_tensor`` — all-reduce over ``tensor`` forward, identity
     backward: the row-parallel o and down outputs, the vocabulary-split
     embedding lookup;
  4. ``gather_tensor`` — all-gather over ``tensor`` forward (the vocabulary
     split logits), the rank's slice backward;
  5. ``gather_seq`` — all-gather over ``seq`` of the final hidden states
     forward, the rank's block backward;
  6. ``reduce_grads`` — the adapters' gradients summed over ``data`` and
     ``seq``, and over ``tensor`` for the leaves replicated over it (A, and
     the row-parallel projections' B);
  7. ``sum_over`` — the answer-window loss's sums over ``data``; the
     scorers' rows over ``data``;
  8. ``gather_folds`` — per-fold values (losses, probabilities, adapters and
     AdamW moments for a checkpoint) from the ``fold`` axis; ``scatter``
     on a checkpoint's load is each rank's slice of what every rank reads;
  9. the ring's ``batch_isend_irecv`` of K/V blocks around ``seq``
     (tst_torch.kernels.ring_attention).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tst_torch.models.quant import INT4_GROUP, is_int4_leaf, is_quantized_leaf

AXES = ("fold", "data", "seq", "tensor")
#: a PartitionSpec: for each dimension of a leaf, the mesh axis that splits it
PSpec = Tuple[Optional[str], ...]
#: seconds a collective waits before it fails (a hung rank raises)
TIMEOUT_S = 600


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S,
                     backend: Optional[str] = None) -> bool:
    """Join the process group of a launch over several ranks: torchrun's
    variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
    ``LOCAL_RANK``) or the reference's (``COORDINATOR_ADDRESS`` host:port,
    ``NUM_PROCESSES``, ``PROCESS_ID``). ``backend``: NCCL by default where
    there is a card (each rank on card ``LOCAL_RANK``), gloo otherwise. A
    no-op returning False when nothing says the launch has several
    processes; True once joined."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = num_processes or _env_int("WORLD_SIZE", "NUM_PROCESSES")
    coord = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if not (world or coord or os.environ.get("MASTER_ADDR")):
        return False
    rank = process_id if process_id is not None else _env_int("RANK", "PROCESS_ID")
    if world is None or rank is None:
        raise ValueError("a launch over several processes needs its world size and this "
                         "process's rank (WORLD_SIZE/RANK or NUM_PROCESSES/PROCESS_ID)")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(_env_int("LOCAL_RANK") or 0)
    init = f"tcp://{coord}" if coord else "env://"
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return True


def free_port() -> int:
    """A free TCP port on this host, for a process group of local ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned_rank(fn, rank: int, world: int, backend: str, port: int, timeout_s: float,
                  args, results) -> None:
    """One rank of :func:`spawn_ranks`: torchrun's variables, the process
    group, ``fn``, a last barrier → (rank, "ok" | "error", result or
    traceback) on ``results``."""
    try:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(port))
        if backend == "gloo":
            torch.set_num_threads(1)
        init_distributed(f"127.0.0.1:{port}", world, rank, timeout_s=timeout_s, backend=backend)
        try:
            out = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, "ok", out))
    except BaseException:  # the parent raises with it
        results.put((rank, "error", traceback.format_exc()))


def spawn_ranks(fn, world: int, backend: str, *args, deadline_s: float = 900.0,
                timeout_s: float = TIMEOUT_S) -> list:
    """``fn(rank, world, *args)`` in ``world`` spawned processes joined over
    ``backend`` on a free local port (NCCL: rank r on card r; gloo: one
    torch thread a rank) → their results by rank. ``fn`` and its results
    must pickle. Raises with the first failed rank's traceback, or when
    ``deadline_s`` passes; the processes are stopped either way."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned_rank,
                         args=(fn, r, world, backend, port, timeout_s, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, Any] = {}
    error = None
    end = time.monotonic() + deadline_s
    try:
        while len(got) < world and error is None:
            try:
                rank, status, out = results.get(timeout=max(end - time.monotonic(), 0.1))
            except queue_mod.Empty:
                error = (f"no result from {world - len(got)} of {world} ranks within "
                         f"{deadline_s} s")
                break
            if status == "ok":
                got[rank] = out
            else:
                error = f"rank {rank} failed:\n{out}"
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 1)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    if error is not None:
        raise RuntimeError(f"{getattr(fn, '__name__', fn)} on {world} {backend} ranks: {error}")
    return [got[r] for r in range(world)]


def rank_grid(fold: int, data: int, seq: int, tensor: int, world: int,
              nodes: int = 1) -> np.ndarray:
    """The ranks laid out ``[fold, data, seq, tensor]``, row-major: with
    several nodes (``LOCAL_WORLD_SIZE`` ranks each, numbered node by node)
    the fold axis is the one that crosses them, as the reference lays its
    fold axis across slices: fold models never exchange tensors mid-step."""
    need = fold * data * seq * tensor
    if need > world:
        raise ValueError(f"mesh {fold}x{data}x{seq}x{tensor} needs {need} ranks, have {world}")
    if need < world:
        raise ValueError(f"mesh {fold}x{data}x{seq}x{tensor} uses {need} of the {world} "
                         "ranks; size the launch to the mesh")
    if nodes > 1 and fold % nodes:
        raise ValueError(f"multi-node mesh: fold={fold} must be divisible by the {nodes} "
                         "nodes (the fold axis is the one between nodes)")
    return np.arange(world).reshape(fold, data, seq, tensor)


@dataclasses.dataclass
class Mesh:
    """This rank's place in a ``(fold, data, seq, tensor)`` mesh, and the
    process group of each axis it spans (None where the axis has size 1)."""

    devices: np.ndarray  # [fold, data, seq, tensor] ranks (the reference's name)
    rank: int
    groups: Dict[str, Any]

    axis_names = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        where = np.argwhere(self.devices == self.rank)[0]
        return int(where[AXES.index(axis)])

    @property
    def n_ranks(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(fold: int = 1, data: int = 1, tensor: int = 1, seq: int = 1) -> Mesh:
    """The ``(fold, data, seq, tensor)`` mesh over the launch's ranks; raises
    when it needs more ranks than exist (or leaves some out)."""
    joined = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    rank = dist.get_rank() if joined else 0
    local = _env_int("LOCAL_WORLD_SIZE") or world
    grid = rank_grid(fold, data, seq, tensor, world, nodes=max(world // max(local, 1), 1))
    groups: Dict[str, Any] = {}
    for ax_i, axis in enumerate(AXES):
        if grid.shape[ax_i] == 1:
            continue
        lines = np.moveaxis(grid, ax_i, -1).reshape(-1, grid.shape[ax_i])
        for line in lines:  # every rank creates every group, in one order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(grid, rank, groups)


def is_main() -> bool:
    """Rank 0 of the launch (or the only process): the one that writes a
    run's artifacts and logs."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def from_config(mesh_cfg) -> Mesh:
    return make_mesh(mesh_cfg.fold, mesh_cfg.data, mesh_cfg.tensor, getattr(mesh_cfg, "seq", 1))


def active(mesh: Optional[Mesh]) -> bool:
    """A mesh of more than one rank."""
    return mesh is not None and mesh.n_ranks > 1


#: logical model axis (tst.models.decoder.PARAM_AXES) → mesh axis
LOGICAL_RULES: Dict[str, Optional[str]] = {
    "vocab": "tensor",
    "embed": "data",  # FSDP: base weights sharded over the data axis
    "heads": "tensor",
    "ffn": "tensor",
    "layer": None,  # the layer axis is never sharded
}

#: a copy of ``tst.models.decoder.PARAM_AXES``: each base leaf's logical axes
PARAM_AXES: Dict[str, tuple] = {
    "embed": ("vocab", "embed"),
    "final_norm": (None,),
    "lm_head": ("embed", "vocab"),
    "layers.attn_norm": ("layer", None),
    "layers.wq": ("layer", "embed", "heads"),
    "layers.wk": ("layer", "embed", "heads"),
    "layers.wv": ("layer", "embed", "heads"),
    "layers.wo": ("layer", "heads", "embed"),
    "layers.bq": ("layer", "heads"),
    "layers.bk": ("layer", "heads"),
    "layers.bv": ("layer", "heads"),
    "layers.mlp_norm": ("layer", None),
    "layers.w_gate": ("layer", "embed", "ffn"),
    "layers.w_up": ("layer", "embed", "ffn"),
    "layers.w_down": ("layer", "ffn", "embed"),
}
#: the projections whose input dimension the tensor axis splits
ROW_PARALLEL = ("o", "down")


def base_param_pspec(path: str) -> PSpec:
    """Which mesh axis splits each dimension of a base leaf, by its path."""
    axes = PARAM_AXES.get(path)
    if axes is None:
        raise KeyError(f"no sharding axes registered for param {path!r}")
    return tuple(LOGICAL_RULES.get(a) for a in axes)


def lora_param_pspec(leaf_name: str, with_fold_axis: bool = True) -> PSpec:
    """LoRA adapters: A [fold?, L, r, in] replicated, B [fold?, L, out, r]
    split on its output over ``tensor``, like the base projection it
    patches (the reference's rule; the row-parallel o and down keep B whole
    on a rank, :func:`lora_local_pspec`)."""
    if leaf_name == "a":
        inner = (None, None, None)
    elif leaf_name == "b":
        inner = (None, "tensor", None)
    else:
        raise KeyError(f"unexpected LoRA leaf {leaf_name!r}")
    return (("fold",) if with_fold_axis else ()) + inner


def lora_local_pspec(proj: str, leaf_name: str, with_fold_axis: bool = True) -> PSpec:
    """What a rank holds of an adapter leaf: the reference's rule, except that
    the row-parallel projections (o, down), whose outputs every tensor rank
    sums whole, keep B whole (their inputs are what the tensor axis splits;
    each rank uses its columns of A)."""
    spec = lora_param_pspec(leaf_name, with_fold_axis)
    if proj in ROW_PARALLEL:
        spec = tuple(None if a == "tensor" else a for a in spec)
    return spec


def param_pspec_tree(params) -> Any:
    """A base tree → the matching tree of pspecs. Layer leaves resolve as
    ``layers.<name>``. A quantized leaf's scale splits on its output axis
    only, like the weight's last axis."""

    def walk(node, path):
        if isinstance(node, dict):
            if "q" in node and "scale" in node:
                wspec = base_param_pspec(path)
                srank = node["scale"].ndim
                return {"q": wspec, "scale": tuple([None] * (srank - 1) + [wspec[-1]])}
            return {k: walk(v, f"{path}.{k}" if path else k) for k, v in node.items()}
        return base_param_pspec(path)

    return walk(params, "")


def leaf_pspec(path: str, leaf) -> Any:
    """The pspec of one base leaf (stacked, or one layer's slice of it): a
    tuple, or ``{"q", "scale"}`` for a quantized leaf, with the stacked
    leaf's rank (:func:`gather_data` drops the leading layer axis)."""
    wspec = base_param_pspec(path)
    if isinstance(leaf, dict) and is_quantized_leaf(leaf):
        srank = leaf["scale"].ndim + len(wspec) - leaf["q"].ndim
        return {"q": wspec, "scale": tuple([None] * (srank - 1) + [wspec[-1]])}
    return wspec


def lora_pspec_tree(lora, with_fold_axis: bool = True) -> Any:
    def walk(node, leaf_name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return lora_param_pspec(leaf_name, with_fold_axis)

    return walk(lora)


def batch_pspec(with_fold_axis: bool = True) -> PSpec:
    """Token batches: [fold?, batch, seq] → fold × data."""
    return (("fold",) if with_fold_axis else ()) + ("data", None)


def mesh_axis_sizes(mesh: Mesh) -> Dict[str, int]:
    return dict(mesh.shape)


# ---------------------------------------------------------------------------
# keeping a rank's slice


def _slice(x: torch.Tensor, dim: int, mesh: Mesh, axis: str, what: str) -> torch.Tensor:
    n = mesh.size(axis)
    if x.shape[dim] % n:
        raise ValueError(f"{what}: width {x.shape[dim]} (dimension {dim}) does not split "
                         f"over the {n} ranks of the {axis!r} axis")
    size = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * size, size)


def int4_values(q: torch.Tensor) -> torch.Tensor:
    """A packed-int4 ``q`` [..., in, out/2] → its int8 values [..., in, out]
    in column order."""
    return torch.cat([(q & 0xF) - 8, q >> 4], dim=-1)


def int4_pack(vals: torch.Tensor) -> torch.Tensor:
    """:func:`int4_values`' inverse: planar nibbles of [..., in, out] values."""
    half = vals.shape[-1] // 2
    hi, lo = vals[..., half:].to(torch.int16), vals[..., :half].to(torch.int16)
    return ((hi << 4) + (lo + 8)).to(torch.int8)


def _group_span(vals: torch.Tensor, scale: torch.Tensor, mesh: Mesh, what: str):
    """A row-parallel int4 leaf's input rows as this rank of ``tensor`` holds
    them → (the int values of the whole 128-row groups its rows touch, their
    scales, ``{}`` when those rows are its own, else ``{"rows": ...}``:
    int64 [..., 2] on the host, the offset of its first row in the first
    group and its row count). GSPMD pads such a shard the same way: the
    groups' other rows meet zero inputs (:func:`pad_rows`), so the partial
    sums are the unpadded ones."""
    dim = vals.ndim - 2
    k_local = _slice(vals, dim, mesh, "tensor", what).shape[dim]
    lo = mesh.index("tensor") * k_local
    g0, g1 = lo // INT4_GROUP, -(-(lo + k_local) // INT4_GROUP)
    vals = vals.narrow(dim, g0 * INT4_GROUP, (g1 - g0) * INT4_GROUP)
    scale = scale.narrow(scale.ndim - 3, g0, g1 - g0)
    if vals.shape[dim] == k_local:
        return vals, scale, {}
    rows = torch.tensor([lo - g0 * INT4_GROUP, k_local], dtype=torch.int64)
    return vals, scale, {"rows": rows.expand(*vals.shape[:dim], 2).contiguous()}


def shard_leaf(x, spec, mesh: Mesh, what: str = "leaf"):
    """This rank's slice of a plain or quantized leaf. A packed-int4 leaf is
    split on its column values and packed again, so a rank's slice is a
    packed leaf of its own columns. When the tensor axis splits its input
    (row-parallel, o and down), the rank keeps the whole 128-row groups its
    rows touch and their scales; where those hold rows of another rank (a
    group split between ranks), the leaf carries ``rows``
    (:func:`_group_span`), which :func:`pad_rows` and :func:`own_rows`
    read."""
    if isinstance(x, dict) and is_quantized_leaf(x):
        qspec, sspec = spec["q"], spec["scale"]
        q, scale, extra = x["q"], x["scale"], {}
        if is_int4_leaf(x):
            vals = int4_values(q)
            for dim, axis in enumerate(qspec):
                if axis is None or mesh.size(axis) == 1:
                    continue
                if axis == "tensor" and dim == len(qspec) - 2:  # row-parallel
                    vals, scale, extra = _group_span(vals, scale, mesh, what)
                else:
                    vals = _slice(vals, dim, mesh, axis, what)
            q = int4_pack(vals)
        else:
            for dim, axis in enumerate(qspec):
                if axis is not None and mesh.size(axis) > 1:
                    q = _slice(q, dim, mesh, axis, what)
        for dim, axis in enumerate(sspec):
            if axis is not None and mesh.size(axis) > 1:
                scale = _slice(scale, dim, mesh, axis, what)
        return {"q": q.contiguous(), "scale": scale.contiguous(), **extra}
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            x = _slice(x, dim, mesh, axis, what)
    return x.contiguous()


def _own_rows_of(leaf) -> Optional[Tuple[int, int]]:
    """(offset of the rank's first row in the shard, its row count), or None
    for a leaf without ``rows``."""
    if not isinstance(leaf, dict) or "rows" not in leaf:
        return None
    row0, n = (int(v) for v in leaf["rows"].reshape(-1, 2)[0])
    return row0, n


def pad_rows(y: torch.Tensor, leaf) -> torch.Tensor:
    """The input of a row-parallel product against this rank's shard ``leaf``:
    ``y`` [..., rows of its own] with zero columns before and after, to the
    span of the whole int4 groups the shard holds (unchanged for a leaf
    without ``rows``)."""
    own = _own_rows_of(leaf)
    if own is None:
        return y
    row0, n = own
    if y.shape[-1] != n:
        raise ValueError(f"input width {y.shape[-1]} is not the shard's {n} rows")
    return torch.nn.functional.pad(y, (row0, leaf["q"].shape[-2] - row0 - n))


def own_rows(w: torch.Tensor, leaf) -> torch.Tensor:
    """A dequantized shard ``w`` [..., span, out] of ``leaf`` cut to the rows
    of this rank (unchanged for a leaf without ``rows``): what a gather of the
    whole leaf takes from it."""
    own = _own_rows_of(leaf)
    return w if own is None else w.narrow(-2, *own)


def shard_tree(tree, pspecs, mesh: Mesh):
    """Keep this rank's slice of every leaf (the reference places each leaf
    with its NamedSharding; here a rank holds only its own part)."""

    def walk(node, spec, path):
        if isinstance(node, dict) and not is_quantized_leaf(node):
            return {k: walk(v, spec[k], f"{path}.{k}" if path else k) for k, v in node.items()}
        return shard_leaf(node, spec, mesh, what=path)

    return walk(tree, pspecs, "")


def local_lora(lora, mesh: Optional[Mesh], with_fold_axis: bool = True, folds: bool = True):
    """A rank's part of a (fold-stacked) adapter tree: its block of folds
    (``folds=False``: every fold, as a served adapter's) and B's output
    slice on the column-parallel projections."""
    if not active(mesh) or lora is None:
        return lora

    def spec(p, n):
        s = lora_local_pspec(p, n, with_fold_axis)
        return s if folds else tuple(None if a == "fold" else a for a in s)

    return {p: {n: shard_leaf(t, spec(p, n), mesh, f"lora.{p}.{n}") for n, t in ab.items()}
            for p, ab in lora.items()}


# ---------------------------------------------------------------------------
# collectives (the list in the module docstring)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    y = _for_backend(x.contiguous())
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_data(leaf, spec, mesh: Optional[Mesh]):
    """(1) A base leaf (one layer's, or a top-level one) made whole over the
    ``data`` axis: all-gathered along the dimensions that axis splits. No
    gradient flows into the frozen base."""
    if mesh is None or mesh.size("data") == 1:
        return leaf
    group = mesh.group("data")
    with torch.no_grad():
        if isinstance(leaf, dict) and is_quantized_leaf(leaf):
            q, scale = leaf["q"], leaf["scale"]
            # a layer's leaf drops the spec's leading layer axis
            qspec = spec["q"][len(spec["q"]) - q.ndim:]
            sspec = spec["scale"][len(spec["scale"]) - scale.ndim:]
            if "data" in qspec:
                dim = qspec.index("data")
                if is_int4_leaf(leaf):
                    q = int4_pack(_all_gather(int4_values(q), group, dim))
                else:
                    q = _all_gather(q, group, dim)
            if "data" in sspec:
                scale = _all_gather(scale, group, sspec.index("data"))
            return {**leaf, "q": q, "scale": scale}
        spec = spec[len(spec) - leaf.ndim:]
        if "data" not in spec:
            return leaf
        return _all_gather(leaf, group, spec.index("data"))


class _GatherApply(torch.autograd.Function):
    """y ↦ fn(y, gathered leaf), the leaf gathered in the forward and again
    in the backward, so no whole leaf outlives its use."""

    @staticmethod
    def forward(ctx, y, fn, gather, *shards):
        ctx.fn, ctx.gather = fn, gather
        ctx.save_for_backward(y, *shards)
        with torch.no_grad():
            return fn(y, gather(*shards))

    @staticmethod
    def backward(ctx, dout):
        y, *shards = ctx.saved_tensors
        with torch.enable_grad():
            y2 = y.detach().requires_grad_(True)
            out = ctx.fn(y2, ctx.gather(*shards))
            (dy,) = torch.autograd.grad(out, y2, dout)
        return (dy, None, None) + (None,) * len(shards)


def fsdp_apply(fn, y: torch.Tensor, leaf, spec, mesh: Optional[Mesh]):
    """``fn(y, leaf)`` with ``leaf`` FSDP-sharded over ``data``: the whole
    leaf exists only inside the call, forward and backward. Without a
    ``data`` split, ``fn(y, leaf)``."""
    if mesh is None or mesh.size("data") == 1:
        return fn(y, leaf)
    if isinstance(leaf, dict):
        keys = sorted(leaf)
        shards = [leaf[k] for k in keys]

        def gather(*ts):
            return gather_data(dict(zip(keys, ts)), spec, mesh)
    else:
        shards = [leaf]

        def gather(t):
            return gather_data(t, spec, mesh)
    if not y.requires_grad:
        return fn(y, gather(*shards))
    return _GatherApply.apply(y, fn, gather, *shards)


class _ToTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromTensor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone().contiguous()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        ctx.size = x.shape[dim]
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        i = dist.get_rank(ctx.group)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None


def to_tensor(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(2) The input of a column-parallel product: its gradient is summed
    over ``tensor``."""
    if mesh is None or mesh.size("tensor") == 1:
        return x
    return _ToTensor.apply(x, mesh.group("tensor"))


def from_tensor(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(3) Partial sums of a row-parallel product summed over ``tensor``."""
    if mesh is None or mesh.size("tensor") == 1:
        return x
    return _FromTensor.apply(x, mesh.group("tensor"))


def gather_tensor(x: torch.Tensor, mesh: Optional[Mesh], dim: int = -1) -> torch.Tensor:
    """(4) Vocabulary-split logits made whole over ``tensor``."""
    if mesh is None or mesh.size("tensor") == 1:
        return x
    return _GatherDim.apply(x, mesh.group("tensor"), dim % x.ndim)


def gather_seq(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 1) -> torch.Tensor:
    """(5) Sequence blocks made whole over ``seq``."""
    if mesh is None or mesh.size("seq") == 1:
        return x
    return _GatherDim.apply(x, mesh.group("seq"), dim % x.ndim)


def _for_backend(x: torch.Tensor) -> torch.Tensor:
    """NCCL moves CUDA tensors only: a host tensor goes to the card first."""
    if x.device.type == "cpu" and dist.get_backend() == "nccl":
        return x.cuda()
    return x


def sum_over(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]) -> torch.Tensor:
    """(7) ``x`` summed over the named axes (no gradient)."""
    if mesh is None or all(mesh.size(a) == 1 for a in axes):
        return x
    y = _for_backend(x.detach().clone().contiguous())
    for axis in axes:
        if mesh.size(axis) > 1:
            dist.all_reduce(y, group=mesh.group(axis))
    return y.to(x.device)


def reduce_grads(grads, mesh: Optional[Mesh], ring: bool = False):
    """(6) Each adapter gradient summed over ``data``, over ``seq`` when the
    ring splits the sequence (else the seq ranks are replicas), and over
    ``tensor`` where the rank holds the whole leaf (A, and B of o and
    down)."""
    if not active(mesh):
        return grads
    out = {}
    for p, ab in grads.items():
        out[p] = {}
        for n, g in ab.items():
            axes = ["data", "seq"] if ring else ["data"]
            if "tensor" not in lora_local_pspec(p, n):
                axes.append("tensor")
            out[p][n] = sum_over(g, mesh, axes)
    return out


def any_over(flag: bool, mesh: Optional[Mesh], axes: Sequence[str]) -> bool:
    """(7) True when ``flag`` holds on any rank of the named axes: loops
    whose steps run collectives (speculative decode's rounds under FSDP)
    end on every rank together."""
    if not active(mesh) or all(mesh.size(a) == 1 for a in axes):
        return bool(flag)
    return bool(sum_over(torch.tensor([int(flag)]), mesh, axes).item() > 0)


def gather_folds(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """(8) A [k_local, ...] per-fold tensor → [k, ...] on every rank."""
    if mesh is None or mesh.size("fold") == 1:
        return x
    return _all_gather(x.detach(), mesh.group("fold"), 0)


def gather_leaf(x: torch.Tensor, spec: PSpec, mesh: Optional[Mesh]) -> torch.Tensor:
    """(7, 8) A tensor made whole over every axis its spec names: a
    checkpoint's leaves on save, the scorers' and decoders' shares of rows
    over ``data``."""
    if not active(mesh):
        return x
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.size(axis) > 1:
            x = _all_gather(x.detach(), mesh.group(axis), dim)
    return x


def fold_range(k: int, mesh: Optional[Mesh]) -> range:
    """The folds this rank steps: a contiguous block of k / fold."""
    if mesh is None or mesh.size("fold") == 1:
        return range(k)
    n = mesh.size("fold")
    if k % n:
        raise ValueError(f"k={k} folds do not split over the {n} ranks of the 'fold' axis")
    per = k // n
    return range(mesh.index("fold") * per, (mesh.index("fold") + 1) * per)


def barrier(mesh: Optional[Mesh]) -> None:
    if active(mesh):
        dist.barrier()
