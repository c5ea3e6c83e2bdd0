"""The port's native byte packer (tst_torch.native, its own copy of
tst/native) against the port's Python path and against tst's native packer,
on the same datasets made from a seed: every TokenBatch field bit-equal.
Also the routing of ``tokenize_dataset``'s backends, the error on a target
that nearly fills its bucket, and where the library is built and what is
loaded.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from test_torch_host import bpe_tokenizer_dir
from tst.data.schema import BlindDataset as JBlindDataset
from tst.data.schema import Sample as JSample
from tst.data.synthetic import make_synthetic_mcq as jmake_mcq
from tst.data.synthetic import make_synthetic_numeric as jmake_numeric
from tst.data.tokenize import ByteTokenizer as JByteTokenizer
from tst.data.tokenize import tokenize_dataset as jtokenize
from tst_torch.data.schema import BlindDataset, Sample
from tst_torch.data.synthetic import make_synthetic_mcq, make_synthetic_numeric
from tst_torch.data.tokenize import ByteTokenizer, HFTokenizer, tokenize_dataset
from tst_torch.native import fast_pack

REPO = Path(__file__).resolve().parent.parent
FIELDS = ("tokens", "loss_mask", "answer_pos", "lengths", "gold", "n_options",
          "option_token_ids", "pad_id", "option_token_seqs")

pytestmark = pytest.mark.skipif(not fast_pack.native_available(), reason="no g++")


def _mixed(schema_ds, mcq, numeric, seed):
    return schema_ds("mixed", list(mcq(n=24, bias_fraction=0.5, seed=seed))
                     + list(numeric(n=12, seed=seed)))


def _long(schema_ds, sample, chars):
    """Rows with contexts of ``chars`` characters: head truncation must keep
    each question and options tail."""
    rng = np.random.default_rng(chars)
    words = ["lorem", "ipsum", "dolor", "sit", "amet", "[00:01]", "speaker"]
    rows = []
    for i in range(6):
        ctx = " ".join(rng.choice(words, chars // 5))[:chars]
        rows.append(sample(id=f"long{i}", question=f"Which speaker said item {i}?",
                           options=["alice", "bob", "carol", "dan"][: 2 + i % 3],
                           answer="AB"[i % 2], context=ctx, category="c"))
    return schema_ds("long", rows)


def _unicode(schema_ds, sample):
    return schema_ds("u", [
        sample(id="u0", question="什么颜色 é ü?", options=["红", "蓝"], answer="A",
               category="c", context="ß∂ƒ© " * 40),
        sample(id="u1", question="Ωμέγα — which?", options=["α", "β", "γ"], answer="C",
               category="c"),
    ])


CASES = {
    "plain": (lambda: make_synthetic_mcq(n=64, bias_fraction=0.5, seed=0),
              lambda: jmake_mcq(n=64, bias_fraction=0.5, seed=0), {}),
    "mixed": (lambda: _mixed(BlindDataset, make_synthetic_mcq, make_synthetic_numeric, 1),
              lambda: _mixed(JBlindDataset, jmake_mcq, jmake_numeric, 1), {}),
    "context_100k": (lambda: _long(BlindDataset, Sample, 100_000),
                     lambda: _long(JBlindDataset, JSample, 100_000), {"max_len": 512}),
    "context_100k_bucket": (lambda: _long(BlindDataset, Sample, 100_000),
                            lambda: _long(JBlindDataset, JSample, 100_000), {}),
    "unicode": (lambda: _unicode(BlindDataset, Sample),
                lambda: _unicode(JBlindDataset, JSample), {}),
}


def _assert_same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_equals_python_and_reference(case):
    """backend="native" bit-equal to the port's Python path and to tst's
    native packer on the same rows."""
    port_ds, ref_ds, kw = CASES[case]
    native = tokenize_dataset(port_ds(), ByteTokenizer(), backend="native", **kw)
    _assert_same(native, tokenize_dataset(port_ds(), ByteTokenizer(), backend="python", **kw))
    _assert_same(native, jtokenize(ref_ds(), JByteTokenizer(), backend="native", **kw))
    if case.startswith("context_100k"):
        # the question and options tail survives: the first target token is
        # the gold letter
        first = native.tokens[np.arange(native.n), native.answer_pos + 1]
        np.testing.assert_array_equal(first, native.option_token_ids[native.gold])
        assert (native.lengths == native.seq_len).all()


def test_target_nearly_fills_bucket_raises_naming_the_sample():
    """A target that leaves fewer than 8 prompt tokens in the bucket raises
    ValueError naming the sample, on both paths."""
    rows = [Sample(id="ok", question="q?", options=["a", "b"], answer="A", category="c"),
            Sample(id="huge", question="q?", options=[], answer="x" * 124, answer_type="open",
                   category="c")]
    ds = BlindDataset("t", rows)
    for backend in ("native", "python"):
        with pytest.raises(ValueError, match="sample huge: target alone nearly fills bucket 128"):
            tokenize_dataset(ds, ByteTokenizer(), max_len=128, backend=backend)
    with pytest.raises(ValueError, match="sample 0: target alone nearly fills"):
        fast_pack.pack_byte_batch(b"a" * 20, np.array([0, 20], np.int64), b"bbbb",
                                  np.array([0, 4], np.int64), L=8, pad_id=256, bos_id=257,
                                  eos_id=258)


def test_auto_routes_native(monkeypatch):
    """auto takes the native packer for the byte tokenizer when it builds,
    and the Python path when it does not; native then raises."""
    ds = make_synthetic_mcq(n=16, seed=3)
    calls = []
    real = fast_pack.pack_byte_batch
    monkeypatch.setattr(fast_pack, "pack_byte_batch",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    auto = tokenize_dataset(ds, ByteTokenizer())
    assert calls == [1]
    _assert_same(auto, tokenize_dataset(ds, ByteTokenizer(), backend="python"))
    assert calls == [1]
    monkeypatch.setattr(fast_pack, "native_available", lambda: False)
    _assert_same(tokenize_dataset(ds, ByteTokenizer()), auto)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="native packing requested but unavailable"):
        tokenize_dataset(ds, ByteTokenizer(), backend="native")


def test_native_on_hf_tokenizer_and_unknown_backend_raise(tmp_path):
    ds = make_synthetic_mcq(n=4, seed=0)
    tok = HFTokenizer(bpe_tokenizer_dir(tmp_path / "tok", True))
    with pytest.raises(ValueError, match="native packing only supports the byte tokenizer"):
        tokenize_dataset(ds, tok, backend="native")
    _assert_same(tokenize_dataset(ds, tok), tokenize_dataset(ds, tok, backend="python"))
    with pytest.raises(ValueError, match="unknown tokenize backend"):
        tokenize_dataset(ds, ByteTokenizer(), backend="rust")


def test_build_lands_in_the_port_and_never_loads_the_reference():
    """A fresh process packs natively: the library it loads is the port's,
    under tst_torch/_build/ and keyed by source, flags and machine, and
    tst/native/_fast_pack.so is not mapped."""
    lib = fast_pack.library_path()
    assert lib.parent == REPO / "tst_torch" / "_build" and lib.exists()
    code = (
        "import sys; from tst_torch.data.synthetic import make_synthetic_mcq\n"
        "from tst_torch.data.tokenize import ByteTokenizer, tokenize_dataset\n"
        "tokenize_dataset(make_synthetic_mcq(n=4, seed=0), ByteTokenizer(), backend='native')\n"
        "maps = open('/proc/self/maps').read()\n"
        "print('tst' in sys.modules, 'jax' in sys.modules)\n"
        "print(' '.join(sorted({l.split()[-1] for l in maps.splitlines() "
        "if 'fast_pack' in l})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True).stdout.splitlines()
    assert out[0] == "False False"
    assert out[1].split() == [str(lib)]
    assert "_fast_pack.so" not in out[1]
