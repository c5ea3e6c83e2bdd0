"""Meshes over several ranks in the port (tst_torch.runtime.mesh), against
``tst.runtime.mesh`` and against one process.

Construction and the sharding rules run in this process. Sharded training
runs in spawned gloo processes (tests/_torch_mesh_ranks.py: the tiny spec in
f32, one torch thread a rank, a join deadline), at (fold=2), (data=2),
(seq=2, the ring), (tensor=2), (data=2, tensor=2), under remat modes, with
LoRA dropout (each rank's window of the one-process masks), with the fused
MLP's plain path, and on an int4 base. Per-fold losses and held-out
probabilities equal the port's one-process run within 1e-5 relative (f32
sums in another order); one mesh is held to ``tst``'s FoldTrainer on the
same mesh of fake devices at the port's one-device f32 parity tolerance
(1e-5; the reference holds its own mesh to its one device at 2e-3,
tests/test_mesh.py:99-100).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _torch_mesh_ranks import run_ranks, train_one, train_rank
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.models import quant as jquant
from tst.runtime import mesh as jmesh
from tst_torch.models import quant as tquant
from tst_torch.models.decoder import check_tensor_widths, init_params
from tst_torch.models.spec import spec_by_name
from tst_torch.runtime import mesh as tmesh

RTOL = 1e-5
TINY = jdec.spec_by_name("tiny", dtype=jnp.float32)
#: ``small`` widened so that o's and down's 384 input rows split into 192 a
#: rank at tensor=2: 1.5 int4 groups (``small``'s own 128 and 512 split whole)
INT4_SPLIT = {"d_model": 384, "n_heads": 24, "d_ff": 384}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fake_mesh(fold=1, data=1, seq=1, tensor=1, rank=0):
    """A Mesh with no process groups: enough for the slicing rules."""
    return tmesh.Mesh(np.arange(fold * data * seq * tensor).reshape(fold, data, seq, tensor),
                      rank, {})


# --- construction ----------------------------------------------------------


def test_axes_and_one_rank():
    mesh = tmesh.make_mesh()
    assert mesh.axis_names == jmesh.AXES == ("fold", "data", "seq", "tensor")
    assert mesh.devices.shape == (1, 1, 1, 1) and not tmesh.active(mesh)
    assert tmesh.mesh_axis_sizes(mesh) == {"fold": 1, "data": 1, "seq": 1, "tensor": 1}


@pytest.mark.parametrize("shape", [(2, 1, 1, 1), (1, 4, 1, 4), (1, 1, 2, 1)])
def test_too_many_ranks_raise(shape):
    with pytest.raises(ValueError, match="needs .* ranks, have 1"):
        tmesh.make_mesh(fold=shape[0], data=shape[1], seq=shape[2], tensor=shape[3])


def test_rank_grid_and_the_multi_node_fold_layout():
    grid = tmesh.rank_grid(2, 2, 1, 2, world=8)
    assert grid.shape == (2, 2, 1, 2) and grid[1, 0, 0, 1] == 5
    # two nodes of four ranks: each fold's ranks on one node
    grid = tmesh.rank_grid(4, 1, 1, 2, world=8, nodes=2)
    for f in range(4):
        assert len({int(r) // 4 for r in grid[f].ravel()}) == 1
    with pytest.raises(ValueError, match="fold=3 must be divisible by the 2 nodes"):
        tmesh.rank_grid(3, 1, 1, 2, world=6, nodes=2)
    with pytest.raises(ValueError, match="uses 4 of the 8 ranks"):
        tmesh.rank_grid(2, 2, 1, 1, world=8)


def test_init_distributed_is_a_no_op_without_its_variables(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK", "COORDINATOR_ADDRESS",
                 "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert tmesh.init_distributed() is False
    assert not torch.distributed.is_initialized()


def test_pspec_rules_equal_the_reference_leaf_by_leaf():
    assert tmesh.LOGICAL_RULES == jmesh.LOGICAL_RULES
    assert tmesh.PARAM_AXES == jdec.PARAM_AXES
    for path in jdec.PARAM_AXES:
        assert tmesh.base_param_pspec(path) == tuple(jmesh.base_param_pspec(path)), path
    for leaf in ("a", "b"):
        for fold_axis in (True, False):
            assert tmesh.lora_param_pspec(leaf, fold_axis) == tuple(
                jmesh.lora_param_pspec(leaf, fold_axis))
    assert tmesh.batch_pspec() == tuple(jmesh.batch_pspec())
    # quantized leaves: the scale splits on the output axis only
    for bits in (8, 4):
        jp = jquant.quantize_params(jdec.init_params(jax.random.key(0), jdec.spec_by_name(
            "small", dtype=jnp.float32)), bits=bits)
        tp = tquant.quantize_params(init_params(torch.Generator().manual_seed(0), spec_by_name(
            "small", dtype=torch.float32)), bits=bits)
        want = jax.tree.map(tuple, jmesh.param_pspec_tree(jp),
                            is_leaf=lambda x: isinstance(x, P))
        assert tmesh.param_pspec_tree(tp) == want
    lora = {"q": {"a": np.zeros((2, 2, 4, 8)), "b": np.zeros((2, 2, 8, 4))}}
    assert tmesh.lora_pspec_tree(lora) == jax.tree.map(
        tuple, jmesh.lora_pspec_tree(lora), is_leaf=lambda x: isinstance(x, P))


def test_shards_put_back_together_are_the_leaf():
    """Every rank's slice of every leaf, plain, int8 and packed int4,
    concatenated in rank order, is the whole leaf; an int4 rank slice is a
    packed leaf of its own columns."""
    # q_dim 256: whole groups on the row-parallel o; QKV biases
    spec = spec_by_name("small", dtype=torch.float32, n_heads=16, qkv_bias=True)
    for bits in (None, 8, 4):
        params = init_params(torch.Generator().manual_seed(0), spec)
        if bits:
            params = tquant.quantize_params(params, bits=bits)
        specs = tmesh.param_pspec_tree(params)
        shards = [tmesh.shard_tree(params, specs, _fake_mesh(data=2, tensor=2, rank=r))
                  for r in range(4)]
        for key in ("wq", "wo", "w_down", "bq"):
            whole = params["layers"][key]
            if bits and isinstance(whole, dict):
                whole = tquant.dequantize_leaf(whole, torch.float32)
            parts = [tquant.dequantize_leaf(s["layers"][key], torch.float32) for s in shards]
            grid = [[parts[d * 2 + t] for t in range(2)] for d in range(2)]
            axes = tmesh.base_param_pspec(f"layers.{key}")
            dim_d = axes.index("data") if "data" in axes else None
            dim_t = axes.index("tensor")
            rows = [torch.cat(grid[d], dim_t) for d in range(2)]
            got = torch.cat(rows, dim_d) if dim_d is not None else rows[0]
            assert torch.equal(got, whole), (bits, key)


def test_widths_the_tensor_axis_does_not_divide_raise():
    check_tensor_widths(spec_by_name("qwen2.5-0.5b"), 2)
    check_tensor_widths(spec_by_name("llama3-8b"), 4)
    with pytest.raises(ValueError, match="n_heads=14 does not split over the 4 ranks"):
        check_tensor_widths(spec_by_name("qwen2.5-0.5b"), 4)
    with pytest.raises(ValueError, match="n_heads=4 does not split over the 3 ranks"):
        check_tensor_widths(spec_by_name("tiny"), 3)


@pytest.mark.parametrize("rank", [0, 1])
def test_row_parallel_int4_shards_hold_the_groups_they_split(rank):
    """Qwen2.5-0.5B's o projection at tensor=2: 448 rows a rank, 3.5 of the
    128-row groups. Each rank holds the 4 whole groups its rows touch and
    their scales (as GSPMD pads), with its offset in the first group; its
    own rows, dequantized, are the leaf's, and its zero-padded input gives
    the rank's partial sum. Qwen's down (2432 rows a rank, 19 groups) keeps
    whole groups and no ``rows``."""
    g = torch.Generator().manual_seed(0)
    leaf = tquant.quantize_leaf(torch.randn(2, 896, 896, generator=g), bits=4)
    mesh = _fake_mesh(tensor=2, rank=rank)
    got = tmesh.shard_leaf(leaf, tmesh.leaf_pspec("layers.wo", leaf), mesh, "layers.wo")
    g0 = rank * 448 // 128
    assert got["q"].shape == (2, 512, 448) and got["scale"].shape == (2, 4, 1, 896)
    assert got["rows"].tolist() == [[rank * 448 - g0 * 128, 448]] * 2
    assert torch.equal(got["scale"], leaf["scale"][:, g0: g0 + 4])
    whole = tquant.dequantize_leaf(leaf, torch.float32)
    mine = tmesh.own_rows(tquant.dequantize_leaf(got, torch.float32), got)
    assert torch.equal(mine, whole[:, rank * 448: (rank + 1) * 448])
    y = torch.randn(3, 896, generator=g)
    y_own = y[:, rank * 448: (rank + 1) * 448]
    layer = {key: t[1] for key, t in got.items()}
    np.testing.assert_allclose(
        tquant.qdot(tmesh.pad_rows(y_own, layer), layer, torch.float32).numpy(),
        (y_own @ whole[1, rank * 448: (rank + 1) * 448]).numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="input width 447 is not the shard's 448 rows"):
        tmesh.pad_rows(y_own[:, 1:], layer)
    w_down = tquant.quantize_leaf(torch.zeros(1, 4864, 896), bits=4)
    got = tmesh.shard_leaf(w_down, tmesh.leaf_pspec("layers.w_down", w_down), mesh,
                           "layers.w_down")
    assert got["q"].shape == (1, 2432, 448) and got["scale"].shape == (1, 19, 1, 896)
    assert "rows" not in got


# --- sharded training against one process -------------------------------------

#: (test id, mesh shape, train_one options); each world size runs in one spawn
CONFIGS = {
    "fold=2": ((2, 1, 1, 1), {}),
    "data=2": ((1, 2, 1, 1), {}),
    "seq=2 ring": ((1, 1, 2, 1), {"ring": True}),
    "tensor=2": ((1, 1, 1, 2), {}),
    "tensor=2 fused mlp": ((1, 1, 1, 2), {"use_pallas": True, "fused_mlp": True}),
    "data=2 tensor=2": ((1, 2, 1, 2), {}),
    "data=2 tensor=2 remat": ((1, 2, 1, 2), {"remat": True}),
    "data=2 tensor=2 remat dots": ((1, 2, 1, 2), {"remat": "dots"}),
    "tensor=2 remat attn": ((1, 1, 1, 2), {"remat": "attn"}),
    "seq=2 ring remat": ((1, 1, 2, 1), {"ring": True, "remat": True}),
    "fold=2 dropout": ((2, 1, 1, 1), {"dropout": 0.1}),
    "seq=2 ring dropout remat": ((1, 1, 2, 1), {"ring": True, "dropout": 0.1, "remat": True}),
    "data=2 tensor=2 dropout": ((1, 2, 1, 2), {"dropout": 0.1}),
    "fold=2 tensor=2 int4": ((2, 1, 1, 2), {"quantize": 4, "spec_name": "small",
                                            "overrides": {"n_heads": 16}}),
}


@pytest.fixture(scope="module")
def sharded():
    """Every CONFIGS run, the ranks of one world size in one spawn; rank 0's
    results and whether all ranks agreed."""
    out = {}
    for world in (2, 4):
        names = [n for n, (shape, _) in CONFIGS.items() if np.prod(shape) == world]
        runs = run_ranks(train_rank, world,
                         [dict(shape=CONFIGS[n][0], **CONFIGS[n][1]) for n in names])
        for i, name in enumerate(names):
            same = all(np.array_equal(r[i][0], runs[0][i][0])
                       and np.array_equal(r[i][1], runs[0][i][1]) for r in runs)
            out[name] = (runs[0][i], same)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_training_matches_one_process(sharded, name):
    shape, opts = CONFIGS[name]
    (losses, probs, lora), same = sharded[name]
    one = train_one((1, 1, 1, 1), **{k: v for k, v in opts.items() if k != "ring"})
    assert same, "the ranks disagree"
    np.testing.assert_allclose(losses, one[0], rtol=RTOL)
    np.testing.assert_allclose(probs, one[1], rtol=RTOL, atol=1e-6)
    for p, ab in one[2].items():
        for n, t in ab.items():
            np.testing.assert_allclose(lora[p][n], t, rtol=1e-4, atol=1e-6)


def _reference_fit(spec, params, lspec, shape):
    """tst's FoldTrainer and held-out scorer on fake devices, mesh ``shape``
    = (fold, data, seq, tensor): 3 steps of 4 rows a fold, k=2 → (per-fold
    losses, probabilities, the weights and initial adapters as numpy
    trees)."""
    from tst.data.adapters import load_benchmark
    from tst.data.folds import kfold_assign
    from tst.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst.train.infer import score_heldout_mcq
    from tst.train.sft import FoldTrainer, make_fold_batches

    ds = load_benchmark("synthetic:0.5", n=24, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=128)
    fold_id = kfold_assign(ds, 2, 0)
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    batches = make_fold_batches(fold_id, 2, 4, 2, seed=0, batch_multiple=shape[1])[:3]
    mesh = jmesh.make_mesh(fold=shape[0], data=shape[1], seq=shape[2], tensor=shape[3])
    trainer = FoldTrainer(spec, lspec, k=2, lr=1e-3, total_steps=3, mesh=mesh, t_max=t_max)
    lora0, opt = trainer.init_state(jax.random.key(1))
    to_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, lora0)  # fit donates
    sharded = jmesh.shard_tree(params, jmesh.param_pspec_tree(params), mesh)
    rep = jmesh.replicated(mesh)
    tokens, mask, pos = (jax.device_put(jnp.asarray(a), rep)
                         for a in (tb.tokens, tb.loss_mask, tb.answer_pos))
    lora, _, log = trainer.fit(sharded, lora0, opt, tokens, mask, batches, all_pos=pos,
                               log_every=1)
    probs = score_heldout_mcq(sharded, lora, spec, lspec, tokens, pos, tb.option_token_ids,
                              tb.n_options, fold_id, 2, batch=8)
    return np.asarray(log.fold_losses), np.asarray(probs), to_np[0], to_np[1]


def test_mesh_training_matches_the_reference_on_the_same_mesh():
    """(data=2, tensor=2): tst's FoldTrainer on 4 fake devices and the port on
    4 gloo ranks, from the same weights and initial adapters (the JAX
    package's), the same folds and batches."""
    params = jdec.init_params(jax.random.key(0), TINY)
    lspec = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
    want_losses, want_probs, params_np, lora_np = _reference_fit(TINY, params, lspec,
                                                                 (1, 2, 1, 2))
    runs = run_ranks(train_rank, 4, [dict(shape=(1, 2, 1, 2), params_np=params_np,
                                          lora_np=lora_np)])
    losses, probs, _ = runs[0][0]
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5)


def test_int4_groups_split_by_the_tensor_axis_match_the_reference():
    """An int4 base whose row-parallel o and down split a 128-row group at
    tensor=2 (``small`` with d_model 384, 24 heads and d_ff 384: 192 rows a
    rank, 1.5 groups) trains on (data=2, tensor=2) with LoRA on o and down:
    tst's FoldTrainer on 4 fake devices (GSPMD pads the shard) and the port
    on 4 gloo ranks (padded shards, ``mesh.pad_rows``), from the reference's
    quantized weights and initial adapters; and the port in one process on
    the same weights. Its adapters are not held to one process's at
    ``test_sharded_training_matches_one_process``'s rtol 1e-4: the
    unpadded controls of scripts/torch_int4_split_control.py (int4 at
    d_model 256, whole groups; this model unquantized; this model on
    data=2 alone) drift past it as well."""
    spec = jdec.spec_by_name("small", dtype=jnp.float32, **INT4_SPLIT)
    params = jquant.quantize_params(jdec.init_params(jax.random.key(0), spec), bits=4)
    assert params["layers"]["wo"]["scale"].ndim == 4  # grouped int4, no int8 fallback
    lspec = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32,
                           targets=("q_proj", "v_proj", "o_proj", "down_proj"))
    want_losses, want_probs, params_np, lora_np = _reference_fit(spec, params, lspec,
                                                                 (1, 2, 1, 2))
    cfg = dict(spec_name="small", overrides=INT4_SPLIT, params_np=params_np, lora_np=lora_np)
    runs = run_ranks(train_rank, 4, [dict(shape=(1, 2, 1, 2), **cfg)])
    losses, probs, _ = runs[0][0]
    one_losses, one_probs, _ = train_one((1, 1, 1, 1), **cfg)
    for want_l, want_p in ((want_losses, want_probs), (one_losses, one_probs)):
        np.testing.assert_allclose(losses, want_l, rtol=RTOL, atol=1e-5)
        np.testing.assert_allclose(probs, want_p, atol=1e-5)
