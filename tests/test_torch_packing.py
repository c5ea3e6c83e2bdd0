"""The port's packer (tst_torch.data.packing) and the packed scorer's row
grid against tst.data.packing / tst.train.infer: bit-equal on the same
tokenized synthetic datasets. The port's packer runs where jax cannot load.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tst.data import packing as jpack
from tst.data.adapters import load_benchmark
from tst.data.folds import kfold_assign
from tst.data.tokenize import ByteTokenizer, tokenize_dataset
from tst.kernels import flash_attention as jfa
from tst.train import infer as jinfer
from tst_torch.data import packing as tpack
from tst_torch.kernels import flash_attention as tfa
from tst_torch.train import infer as tinfer

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tb():
    ds = load_benchmark("synthetic:0.5", n=60, seed=1)
    return tokenize_dataset(ds, ByteTokenizer()), kfold_assign(ds, 3, 1)


def _equal(got, want):
    """Dataclasses (or tuples) of arrays and scalars, field by field."""
    pairs = (zip(dataclasses.astuple(got), dataclasses.astuple(want))
             if dataclasses.is_dataclass(want) else zip(got, want))
    for g, w in pairs:
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_constants_pinned():
    assert tpack.MAX_SEGS == jpack.MAX_SEGS == tfa.MAX_SEGS == jfa.MAX_SEGS == 8
    assert tpack.SEG_PAD == int(jpack.SEG_PAD) == 1 << 30


@pytest.mark.parametrize("pack_len,max_segs", [(1024, 8), (512, 8), (1024, 2), (2048, 8)])
def test_pack_rows_bit_equal(tb, pack_len, max_segs):
    tb, _ = tb
    rows = np.arange(0, tb.n, 2)
    got = tpack.pack_rows(tb, rows, pack_len, max_segs)
    want = jpack.pack_rows(tb, rows, pack_len, max_segs)
    _equal(got, want)
    assert got.n_rows == want.n_rows and got.seq_len == pack_len
    for bad in ((tb, rows, 1000), (tb, rows, 1024, 9), (tb, rows, 128)):
        with pytest.raises(ValueError):
            tpack.pack_rows(*bad)


@pytest.mark.parametrize("k,pack_len,masked", [
    (3, 1024, False), (2, 1024, True), (3, 512, False), (5, 2048, True)])
def test_pack_fold_datasets_bit_equal(tb, k, pack_len, masked):
    """tokens, loss_mask, seg_starts, answer_pos, n_segs, n_rows, pack_len
    and fill_fraction, with and without an include mask."""
    tb, _ = tb
    fold_id = np.random.default_rng(k).integers(0, k, tb.n).astype(np.int32)
    mask = np.random.default_rng(7).random(tb.n) > 0.25 if masked else None
    got = tpack.pack_fold_datasets(tb, fold_id, k, pack_len, include_mask=mask)
    want = jpack.pack_fold_datasets(tb, fold_id, k, pack_len, include_mask=mask)
    _equal(got, want)
    assert got.k == k and 0.0 < got.fill_fraction <= 1.0


@pytest.mark.parametrize("batch,epochs,seed,multiple", [(16, 3, 0, 1), (4, 2, 5, 1), (5, 1, 2, 4)])
def test_make_packed_fold_batches_bit_equal(batch, epochs, seed, multiple):
    n_rows = np.array([85, 86, 40], np.int32)
    got = tpack.make_packed_fold_batches(n_rows, batch, epochs, seed, batch_multiple=multiple)
    want = jpack.make_packed_fold_batches(n_rows, batch, epochs, seed, batch_multiple=multiple)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=">=1 packed row"):
        tpack.make_packed_fold_batches(np.array([3, 0]), 2, 1, 0)


@pytest.mark.parametrize("pack_len,batch", [(1024, 16), (512, 4)])
def test_pack_heldout_mcq_bit_equal(tb, pack_len, batch):
    """The packed scorer's grid: tokens, answer slots, starts (padding rows
    [0, SEG_PAD, ...]) and sample rows; rows outside every fold are left out."""
    tb, fold_id = tb
    fold_id = np.where(np.arange(tb.n) % 7 == 0, -1, fold_id)
    got = tinfer.pack_heldout_mcq(tb, fold_id, 3, pack_len, batch)
    want = jinfer.pack_heldout_mcq(tb, fold_id, 3, pack_len, batch)
    _equal(got, want)
    assert got[0].shape[1] % batch == 0
    assert tinfer.packed_scorer_batch(pack_len) == jinfer.packed_scorer_batch(pack_len)


def test_packer_runs_without_jax():
    """The port's packer imports and runs in a process where jax cannot load
    (tst.data.packing cannot: it imports the Pallas module)."""
    code = (
        "import importlib.abc, sys\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib'):\n"
        "            raise ImportError('jax is blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import numpy as np\n"
        "from tst.data.adapters import load_benchmark\n"
        "from tst.data.tokenize import ByteTokenizer, tokenize_dataset\n"
        "from tst_torch.data.packing import pack_fold_datasets\n"
        "tb = tokenize_dataset(load_benchmark('synthetic:0.5', n=20, seed=0), ByteTokenizer())\n"
        "fp = pack_fold_datasets(tb, np.arange(20) % 2, 2, 1024)\n"
        "assert fp.tokens.shape[0] == 2 and fp.n_segs.sum() == 20\n"
        "assert not any(m.split('.')[0] == 'jax' for m in sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
