"""The port's own copies of tst's jax-free host code, held to tst on the same
inputs: config and presets, the synthetic benchmarks and the benchmark
loader, tokenization (bit-equal arrays), k-fold assignment, the artifact
writers (byte-equal files) and the JSONL run log.

The port imports nothing of tst; these copies keep tst's module names
(``tst_torch.config``, ``tst_torch.data.*``, ``tst_torch.io.outputs``,
``tst_torch.aux.log``).
"""

import dataclasses
import json

import numpy as np
import pytest

from tst import config as jconfig
from tst.aux.log import JsonlLogger as JJsonlLogger
from tst.data import blind as jblind
from tst.data import folds as jfolds
from tst.data import schema as jschema
from tst.data.adapters import load_benchmark as jload
from tst.data.tokenize import ByteTokenizer as JByteTokenizer
from tst.data.tokenize import pad_batch_n as jpad_batch_n
from tst.data.tokenize import tokenize_dataset as jtokenize
from tst.io import outputs as joutputs
from tst_torch import config as tconfig
from tst_torch.aux.log import JsonlLogger as TJsonlLogger
from tst_torch.data import blind as tblind
from tst_torch.data import folds as tfolds
from tst_torch.data import schema as tschema
from tst_torch.data.adapters import load_benchmark as tload
from tst_torch.data.tokenize import ByteTokenizer as TByteTokenizer
from tst_torch.data.tokenize import pad_batch_n as tpad_batch_n
from tst_torch.data.tokenize import tokenize_dataset as ttokenize
from tst_torch.io import outputs as toutputs

#: (benchmark name, n, seed) for the synthetic loaders
BENCHES = [("synthetic:0.5", 24, 0), ("synthetic:0.5", 40, 3),
           ("synthetic:0.3:position", 16, 1), ("synthetic:0.2:keyword", 16, 2),
           ("synthetic-vsi:0.4", 32, 0), ("synthetic-vsi:0.4", 20, 5),
           ("synthetic-open", 16, 0), ("synthetic-open:0.5", 12, 4),
           ("synthetic-numeric", 16, 0), ("synthetic-numeric:0.3", 12, 7)]
TOKEN_FIELDS = ("tokens", "loss_mask", "answer_pos", "lengths", "gold", "n_options",
                "option_token_ids")


def _rows(ds):
    return [s.to_json() for s in ds]


@pytest.mark.parametrize("preset", [None] + sorted(jconfig.PRESETS))
def test_presets_resolve_equal(preset):
    assert tconfig.PRESETS == jconfig.PRESETS
    assert (dataclasses.asdict(tconfig.resolve(preset))
            == dataclasses.asdict(jconfig.resolve(preset)))


def test_resolve_with_file_and_overrides_equal(tmp_path):
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"data": {"k": 3, "n": 64}, "optim": {"score_epochs": [1, 2]},
                                "log_every": 5}))
    overrides = ["model.name=tiny", "optim.lr=3e-4", "data.bench=synthetic-vsi:0.4",
                 "optim.pack=true", "optim.score_epochs=[0]", "out_dir=/tmp/x",
                 'lora.targets=["q_proj","v_proj"]', "model.dtype=float32"]
    for preset in (None, "sft-cvbench-qwen", "ibp-vsibench"):
        got = tconfig.resolve(preset, str(path), overrides)
        want = jconfig.resolve(preset, str(path), overrides)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.to_json() == want.to_json()
        assert isinstance(got.optim.score_epochs, tuple)
    rt = tconfig.RunConfig.from_json(jconfig.resolve("sft-mmmu-llama8b").to_json())
    assert dataclasses.asdict(rt) == dataclasses.asdict(jconfig.resolve("sft-mmmu-llama8b"))
    for mod in (tconfig, jconfig):
        with pytest.raises(AttributeError, match="no config field"):
            mod.resolve(None, None, ["model.nope=1"])
        with pytest.raises(KeyError, match="unknown preset"):
            mod.resolve("nope")
        with pytest.raises(ValueError, match="key=value"):
            mod.resolve(None, None, ["model.name"])


@pytest.mark.parametrize("bench,n,seed", BENCHES)
def test_synthetic_benchmarks_equal(bench, n, seed):
    got, want = tload(bench, n=n, seed=seed), jload(bench, n=n, seed=seed)
    assert isinstance(got, tschema.BlindDataset)
    assert got.name == want.name and len(got) == n
    assert _rows(got) == _rows(want)
    assert got.fingerprint() == want.fingerprint()
    assert got.categories == want.categories
    assert got.chance_accuracy() == want.chance_accuracy()
    for s, w in zip(got, want):
        assert tblind.render_example(s, True) == jblind.render_example(w, True)
        assert tblind.render_example(s, False) == jblind.render_example(w, False)


def test_benchmark_loader_jsonl_and_errors(tmp_path):
    path = tmp_path / "ds.jsonl"
    jload("synthetic-vsi:0.4", n=12, seed=1).save_jsonl(str(path))
    assert _rows(tload(str(path))) == _rows(jload(str(path)))
    for load in (tload, jload):
        with pytest.raises(KeyError, match="unknown benchmark"):
            load("no_such_bench")
    assert tschema.resolve_gold_letter("B", ["x", "y"]) == jschema.resolve_gold_letter(
        "B", ["x", "y"])
    with pytest.raises(ValueError):
        tschema.Sample(id="0", question="q", options=["a"], answer="Z")


@pytest.mark.parametrize("bench,n,seed", BENCHES[::2])
@pytest.mark.parametrize("kw", [{}, {"max_len": 256}, {"include_context": False}])
def test_tokenize_dataset_bit_equal(bench, n, seed, kw):
    ds = jload(bench, n=n, seed=seed)
    got = ttokenize(tload(bench, n=n, seed=seed), TByteTokenizer(), **kw)
    for backend in ("auto", "python"):
        want = jtokenize(ds, JByteTokenizer(), backend=backend, **kw)
        for name in TOKEN_FIELDS:
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and a.shape == b.shape, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert got.pad_id == want.pad_id and got.option_token_seqs is None
    padded, valid = tpad_batch_n(got, 7)
    jpadded, jvalid = jpad_batch_n(want, 7)
    np.testing.assert_array_equal(valid, jvalid)
    for name in TOKEN_FIELDS:
        np.testing.assert_array_equal(getattr(padded, name), getattr(jpadded, name))


def test_tokenize_head_truncates_long_context():
    """A 100k-character context is head-truncated: the question and options
    tail stays, and the first target token is still the gold letter."""
    tbs = []
    for schema, tokenize, tok, kw in ((tschema, ttokenize, TByteTokenizer(), {}),
                                      (jschema, jtokenize, JByteTokenizer(),
                                       {"backend": "python"})):
        s = schema.Sample(id="long", question="Which one is red?", options=["blue", "red"],
                          answer="B", context="lorem ipsum " * 8400)
        tb = tokenize(schema.BlindDataset("long", [s]), tok, max_len=512, **kw)
        assert tb.seq_len == 512 and tb.lengths[0] == 512
        assert tb.tokens[0, tb.answer_pos[0] + 1] == tb.option_token_ids[1]
        tbs.append(tb)
    for name in TOKEN_FIELDS:
        np.testing.assert_array_equal(getattr(tbs[0], name), getattr(tbs[1], name))


@pytest.mark.parametrize("bench,n", [("synthetic:0.5", 48), ("synthetic-vsi:0.4", 40),
                                     ("synthetic-numeric", 17)])
@pytest.mark.parametrize("k,seed", [(2, 0), (3, 1), (5, 7)])
def test_kfold_assign_equal(bench, n, k, seed):
    got = tfolds.kfold_assign(tload(bench, n=n, seed=seed), k, seed)
    want = jfolds.kfold_assign(jload(bench, n=n, seed=seed), k, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfolds.fold_masks(got, k), jfolds.fold_masks(want, k))
    assert tfolds.check_partition(got, k) == jfolds.check_partition(want, k)


def _write_all(outputs, ds, out_dir):
    rng = np.random.default_rng(0)
    n = len(ds)
    s_x = rng.random(n).astype(np.float32)
    s_x[[1, 4]] = np.nan
    fold = rng.integers(0, 3, n)
    outputs.write_sx_table(str(out_dir), ds, s_x, fold, pred=rng.integers(0, 4, n),
                           extra={"p_gold": rng.random(n)})
    outputs.write_debiased_split(str(out_dir), ds, rng.random(n) > 0.3,
                                 audit={"rounds": [{"pruned": 3, "acc": np.float32(0.25)}]})
    outputs.write_report(str(out_dir), {"blind_accuracy": np.float64(0.4375), "k": 3,
                                        "fold_accuracies": [0.5, 0.25], "nan": float("nan")})
    outputs.write_report(str(out_dir), {"x": 1}, name="other.json")


def test_artifact_writers_byte_equal(tmp_path):
    got, want = tmp_path / "port", tmp_path / "tst"
    _write_all(toutputs, tload("synthetic-vsi:0.4", n=30, seed=2), got)
    _write_all(joutputs, jload("synthetic-vsi:0.4", n=30, seed=2), want)
    names = sorted(p.name for p in want.iterdir())
    assert sorted(p.name for p in got.iterdir()) == names
    for name in names:
        if not name.endswith(".parquet"):
            assert (got / name).read_bytes() == (want / name).read_bytes(), name


def test_jsonl_logger_equal_but_timestamps(tmp_path):
    for cls, sub in ((TJsonlLogger, "port"), (JJsonlLogger, "tst")):
        log = cls(str(tmp_path / sub))
        log.log(event="start", n=3)
        log.log(event="train", loss=np.float32(1.5), step=2)
        log.log(event="done", t=9.0)
        log.close()
    lines = {sub: [json.loads(x) for x in (tmp_path / sub / "events.jsonl").read_text()
                   .splitlines()] for sub in ("port", "tst")}
    assert len(lines["port"]) == 3
    for a, b in zip(lines["port"], lines["tst"]):
        assert isinstance(a.pop("t"), float) and isinstance(b.pop("t"), float)
        assert a == b


def bpe_tokenizer_dir(path, letter_merges=True, chat=False):
    """A byte-level BPE saved under ``path`` as an HF tokenizer: with
    ``letter_merges`` " A".." J" are single tokens, as in Llama-3 and
    Qwen2.5 vocabularies, else each is two tokens (the multi-token option
    fallback); ``chat`` gives it a chat template. Built offline with
    ``tokenizers``, as tests/test_hf_tokenizer.py builds one."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers
    from transformers import PreTrainedTokenizerFast

    alphabet = pre_tokenizers.ByteLevel.alphabet()
    vocab = {ch: i for i, ch in enumerate(sorted(alphabet))}
    merges = []
    for letter in jschema.OPTION_LETTERS if letter_merges else ():
        vocab["Ġ" + letter] = len(vocab)
        merges.append(("Ġ", letter))
    tok = Tokenizer(models.BPE(vocab=vocab, merges=merges))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    fast = PreTrainedTokenizerFast(tokenizer_object=tok)
    fast.add_special_tokens({"pad_token": "<pad>", "eos_token": "<eos>",
                             "bos_token": "<bos>"})
    if chat:
        fast.chat_template = (
            "{% for m in messages %}<|{{ m.role }}|>{{ m.content }}<|end|>"
            "{% endfor %}{% if add_generation_prompt %}<|assistant|>{% endif %}")
    fast.save_pretrained(str(path))
    return str(path)


@pytest.mark.parametrize("letter_merges", [True, False])
@pytest.mark.parametrize("style", ["completion", "chat"])
@pytest.mark.parametrize("bench", ["synthetic:0.5", "synthetic-vsi:0.4", "synthetic-open"])
def test_hf_tokenize_bit_equal(tmp_path, letter_merges, style, bench):
    """An HF tokenizer with a chat template, through build_tokenizer
    (``model.tokenizer`` a path, ``data.prompt_style``) and tokenize_dataset:
    the same tokens, masks, answer positions, option ids and multi-token
    option sequences as tst, and the same decoded text and numbers."""
    from tst.models.decode import decode_numeric as jdecode_numeric
    from tst.models.decode import decode_text as jdecode_text
    from tst.train.pipeline import build_tokenizer as jbuild
    from tst_torch.models.decode import decode_numeric, decode_text
    from tst_torch.train.pipeline import build_tokenizer as tbuild

    path = bpe_tokenizer_dir(tmp_path / "tok", letter_merges, chat=True)
    over = [f"model.tokenizer={path}", f"data.prompt_style={style}"]
    ttok = tbuild(tconfig.resolve(None, None, over))
    jtok = jbuild(jconfig.resolve(None, None, over))
    assert ttok.chat == jtok.chat == (style == "chat")
    # a chat prompt's answer is the bare letter, one byte-level token
    single = letter_merges or style == "chat"
    assert ttok.single_token_options == jtok.single_token_options == single
    assert (ttok.vocab_size, ttok.pad_id, ttok.bos_id, ttok.eos_id) == (
        jtok.vocab_size, jtok.pad_id, jtok.bos_id, jtok.eos_id)
    got = ttokenize(tload(bench, n=16, seed=0), ttok)
    want = jtokenize(jload(bench, n=16, seed=0), jtok)
    for name in TOKEN_FIELDS + ("option_token_seqs",):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.option_token_seqs is not None) == (not single and bench != "synthetic-open")
    gen = np.concatenate([got.tokens[:, :6], np.full((16, 1), ttok.eos_id),
                          got.tokens[:, 6:9]], axis=1)
    assert decode_text(gen, ttok) == jdecode_text(gen, jtok)
    np.testing.assert_array_equal(decode_numeric(gen, ttok), jdecode_numeric(gen, jtok))


def test_chat_needs_a_template(tmp_path):
    """``data.prompt_style=chat`` on a tokenizer without a chat template, or
    on the byte tokenizer, raises in both packages."""
    from tst.train.pipeline import build_tokenizer as jbuild
    from tst_torch.train.pipeline import build_tokenizer as tbuild

    path = bpe_tokenizer_dir(tmp_path / "tok", chat=False)
    for tok in (path, "byte"):
        over = [f"model.tokenizer={tok}", "data.prompt_style=chat"]
        for build, config in ((tbuild, tconfig), (jbuild, jconfig)):
            with pytest.raises(ValueError, match="chat template"):
                build(config.resolve(None, None, over))
