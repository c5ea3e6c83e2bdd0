"""The port's entry points (tst_torch/graft_entry.py) against the
reference's (``__graft_entry__.py``), and the dry run's mixed mesh.

``entry()``'s forward at two layers in f32 against ``tst``'s
``apply_model`` on the same weights (bridged), atol 1e-4.
``dryrun_multichip(n, platform="cpu")`` in a cold subprocess, as
tests/test_graft_entry.py runs the reference's, at n=4 (seq=2, tensor=2)
and n=8 (fold=2, seq=2, tensor=2): the OK line, speculative decode exact,
the ring within 1e-4 (~10-20 s each); n=4 once more with legs 1-4 held
to the plain path. On the dry run's (seq=2, tensor=2)
mesh of 4 gloo ranks (tests/_torch_mesh_ranks.py): the packed step's fold
losses and the scorer's probabilities against ``tst``'s FoldTrainer
(packed) on 4 fake devices of the same mesh from the same weights and
adapters (rtol 1e-5, atol 1e-5, as tests/test_torch_mesh.py); the
unpacked step through the ring, and greedy and speculative held-out
tokens, against one process.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_mesh_ranks import dry_mesh_rank, decode_one, run_ranks, train_one
from tst.models import decoder as jdec
from tst.models import lora as jlora
from tst.runtime import mesh as jmesh
from tst_torch import bridge
from tst_torch import graft_entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
#: the dry run's mesh at n=4: (fold, data, seq, tensor)
DRY_MESH = (1, 1, 2, 2)
TINY = jdec.spec_by_name("tiny", dtype=jnp.float32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_entry_is_the_flagship_forward_and_matches_the_reference():
    """Qwen2.5-0.5B's widths, the reference's [4, 512] batch of ones; at 2
    layers in f32 its logits on a [1, 64] batch equal ``tst``'s on the same
    weights."""
    fn, (params, tokens) = graft_entry.entry(platform="cpu", n_layers=2, dtype=torch.float32)
    assert tokens.shape == (4, 512) and tokens.dtype == torch.int64 and bool((tokens == 1).all())
    assert params["embed"].shape == (151936, 896) and params["layers"]["wq"].shape == (2, 896, 896)
    assert params["layers"]["wk"].shape == (2, 896, 128) and "lm_head" not in params
    toks = np.random.default_rng(0).integers(0, 151936, size=(1, 64))
    got = fn(params, torch.from_numpy(toks))
    jspec = jdec.spec_by_name("qwen2.5-0.5b", n_layers=2, dtype=jnp.float32)
    want = jdec.apply_model(jax.tree.map(jnp.asarray, bridge.to_numpy(params)),
                            jnp.asarray(toks, jnp.int32), jspec)
    assert got.shape == (1, 64, 151936) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_entry_defaults_to_bf16():
    _, (params, _) = graft_entry.entry(platform="cpu", n_layers=1)
    assert params["embed"].dtype == torch.bfloat16


@pytest.mark.parametrize("n, shape", [(1, (1, 1, 1, 1)), (2, (1, 1, 1, 2)), (4, (1, 1, 2, 2)),
                                      (8, (2, 1, 2, 2)), (16, (2, 2, 2, 2)),
                                      (6, (1, 3, 1, 2))])
def test_mesh_shape_factors_as_the_reference(n, shape):
    assert tuple(graft_entry.mesh_shape(n)[a] for a in jmesh.AXES) == shape


def test_gpu_with_fewer_cards_than_ranks_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match=r"dryrun_multichip\(4\): needs 4 cards, 1 available"):
        graft_entry.dryrun_multichip(4)
    monkeypatch.undo()
    with pytest.raises(RuntimeError, match=r"needs 2 cards, \d+ available"):
        graft_entry.dryrun_multichip(2, platform="gpu")


@pytest.mark.parametrize("n, mesh, k, against_plain",
                         [(4, "fold=1 data=1 seq=2 tensor=2", 2, False),
                          (8, "fold=2 data=1 seq=2 tensor=2", 4, False),
                          (4, "fold=1 data=1 seq=2 tensor=2", 2, True)])
def test_dryrun_multichip_on_gloo_ranks_cold_subprocess(n, mesh, k, against_plain):
    """Every leg of the dry run in a fresh process (the port never imports
    jax), as tests/test_graft_entry.py runs the reference's: the OK line
    printed once, and the result it was made from passes ``check_result``
    (speculative decode exact, the ring within 1e-4). ``against_plain``
    runs legs 1-4's comparisons under the mixed mesh (on the CPU both
    sides are the plain path: every reading exact)."""
    proc = subprocess.run(
        [sys.executable, "-c", "import json\n"
                               "from tst_torch.graft_entry import dryrun_multichip\n"
                               f"r = dryrun_multichip({n}, platform='cpu', "
                               f"against_plain={against_plain})\n"
                               "print(json.dumps(r))\n"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, f"stderr tail:\n{proc.stderr[-3000:]}"
    result = json.loads(proc.stdout.splitlines()[-1])
    graft_entry.check_result(result, n, against_plain)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip OK")]
    assert lines == [graft_entry.ok_line(result)], proc.stdout
    assert f"mesh {mesh}, k={k}," in lines[0] and result["ring_err"] < 1e-4
    if against_plain:
        vs = result["vs_plain"]
        assert [vs["step"]["loss_gap"], vs["packed_step"]["loss_gap"],
                vs["scorer"]["max_dprob"], vs["decode"]["max_dlogit_rel"]] == [0.0] * 4
        assert vs["step"]["grad_cosine"] == pytest.approx(1.0, abs=1e-6)
        assert vs["packed_step"]["grad_cosine"] == pytest.approx(1.0, abs=1e-6)
    else:
        assert "vs_plain" not in result


def test_a_failed_rank_raises_with_its_traceback():
    """n=3 asks data=3 of tiny's 64-wide FSDP leaves: the rank raises, and
    the parent raises with its traceback and stops every rank."""
    with pytest.raises(RuntimeError, match=r"rank \d failed:(.|\n)*does not split over the 3 "
                                           r"ranks of the 'data' axis"):
        graft_entry.dryrun_multichip(3, platform="cpu")


# --- the dry run's mixed mesh against the reference and one process ----------


@pytest.fixture(scope="module")
def dry_mesh():
    """The reference's packed FoldTrainer and scorer on (seq=2, tensor=2) of
    4 fake devices, and the port's three rank functions on 4 gloo ranks from
    the same weights and adapters (rank 0's results, and whether the ranks
    agree)."""
    from tst.data import packing as jpack
    from tst.data.adapters import load_benchmark
    from tst.data.folds import kfold_assign
    from tst.data.tokenize import ByteTokenizer, tokenize_dataset
    from tst.train.infer import score_heldout_mcq
    from tst.train.sft import FoldTrainer

    params = jdec.init_params(jax.random.key(0), TINY)
    lspec = jlora.LoraSpec(rank=4, alpha=8.0, dtype=jnp.float32)
    ds = load_benchmark("synthetic:0.5", n=24, seed=0)
    tb = tokenize_dataset(ds, ByteTokenizer(), max_len=128)
    fold_id = kfold_assign(ds, 2, 0)
    t_max = int(np.max(tb.lengths - tb.answer_pos - 1))
    fp = jpack.pack_fold_datasets(tb, fold_id, 2, 256)
    batches = jpack.make_packed_fold_batches(fp.n_rows, 2, 1, seed=0)[:2]
    mesh = jmesh.make_mesh(fold=DRY_MESH[0], data=DRY_MESH[1], seq=DRY_MESH[2],
                           tensor=DRY_MESH[3])
    trainer = FoldTrainer(TINY, lspec, k=2, lr=1e-3, total_steps=2, mesh=mesh, t_max=t_max,
                          packed=True)
    lora0, opt = trainer.init_state(jax.random.key(1))
    params_np, lora_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, lora0)
    sharded = jmesh.shard_tree(params, jmesh.param_pspec_tree(params), mesh)
    rep = jmesh.replicated(mesh)
    put = lambda a: jax.device_put(jnp.asarray(a), rep)  # noqa: E731
    lora, _, log = trainer.fit(sharded, lora0, opt, put(fp.tokens), put(fp.loss_mask), batches,
                               all_pos=put(fp.answer_pos), all_segs=put(fp.seg_starts),
                               n_segs=fp.n_segs, log_every=1)
    probs = score_heldout_mcq(sharded, lora, TINY, lspec, put(tb.tokens), put(tb.answer_pos),
                              tb.option_token_ids, tb.n_options, fold_id, 2, batch=8)
    runs = run_ranks(dry_mesh_rank, 4, DRY_MESH, params_np, lora_np)
    same = all(np.array_equal(a, b) for r in runs[1:]
               for a, b in zip(_flat(r), _flat(runs[0])))
    return {"want": (np.asarray(log.fold_losses), np.asarray(probs)), "got": runs[0],
            "same": same}


def _flat(x):
    if isinstance(x, dict):
        return [a for key in sorted(x) for a in _flat(x[key])]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _flat(v)]
    return [np.asarray(x)]


def test_packed_step_and_scorer_on_the_dry_mesh_match_the_reference(dry_mesh):
    (losses, probs), _, _ = dry_mesh["got"]
    want_losses, want_probs = dry_mesh["want"]
    assert dry_mesh["same"], "the ranks disagree"
    np.testing.assert_allclose(losses, want_losses, rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(probs, want_probs, atol=1e-5)


def test_ring_step_on_the_dry_mesh_matches_one_process(dry_mesh):
    _, (losses, probs, lora), _ = dry_mesh["got"]
    one = train_one((1, 1, 1, 1))
    np.testing.assert_allclose(losses, one[0], rtol=RTOL)
    np.testing.assert_allclose(probs, one[1], rtol=RTOL, atol=1e-6)
    for p, ab in one[2].items():
        for n, t in ab.items():
            np.testing.assert_allclose(lora[p][n], t, rtol=1e-4, atol=1e-6)


def test_decode_on_the_dry_mesh_equals_one_process(dry_mesh):
    """Greedy and speculative held-out tokens (fold-stacked adapters, the base
    as the draft) on (seq=2, tensor=2), whose seq ranks are replicas."""
    _, _, decoded = dry_mesh["got"]
    for got, want in zip(decoded, decode_one((1, 1, 1, 1))):
        np.testing.assert_array_equal(got, want)
