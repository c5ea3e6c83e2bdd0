"""The port's HF checkpoint loader (tst_torch.models.hf_load) against
tst.models.hf_load, and its own safetensors reader against the
``safetensors`` package's.

Checkpoints are written here with ``safetensors.numpy`` from seeded numpy
weights: Qwen-like (tied, QKV biases) and Llama-like (untied, llama3
``rope_scaling``), one file or sharded with ``model.safetensors.index.json``,
stored in f32 or bf16. The port's tree is bit-equal to the reference's in
f32 and bf16, and through ``quantizing_put`` its int8 and int4 ``q`` and
``scale`` are too. A subprocess measures the loader's peak host memory:
the model plus about one tensor, never the model twice.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tst.models import hf_load as jhf
from tst.models import llama as jllama
from tst.models import qwen2 as jqwen2
from tst.models import quant as jquant
from tst_torch import bridge
from tst_torch.models import hf_load as thf
from tst_torch.models import llama as tllama
from tst_torch.models import qwen2 as tqwen2
from tst_torch.models import quant as tquant
from tst_torch.models.spec import spec_by_name

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
#: test geometries: every input axis a multiple of 128, so int4 applies
GEOMETRY = {
    "qwen": dict(arch="Qwen2ForCausalLM", d=128, L=2, H=4, KV=2, dh=32, F=256, V=384,
                 tied=True, rope_scaling=None),
    "llama": dict(arch="LlamaForCausalLM", d=128, L=3, H=4, KV=1, dh=32, F=384, V=400,
                  tied=False, rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                            "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                            "original_max_position_embeddings": 8192}),
}
_NP_DTYPES = {"F32": np.float32, "BF16": ml_dtypes.bfloat16, "F16": np.float16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def hf_state_dict(family, stored="F32", seed=0):
    """name → numpy array in HF's layout ([out, in] projections)."""
    g = GEOMETRY[family]
    d, dh, F, V = g["d"], g["dh"], g["F"], g["V"]
    rng = np.random.default_rng(seed)
    dt = _NP_DTYPES[stored]

    def mat(*shape):
        return (rng.normal(size=shape) * 0.05).astype(np.float32).astype(dt)

    sd = {"model.embed_tokens.weight": mat(V, d),
          "model.norm.weight": (1.0 + mat(d).astype(np.float32)).astype(dt)}
    if not g["tied"]:
        sd["lm_head.weight"] = mat(V, d)
    for i in range(g["L"]):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = (1.0 + mat(d).astype(np.float32)).astype(dt)
        sd[pre + "post_attention_layernorm.weight"] = (1.0 + mat(d).astype(np.float32)).astype(dt)
        sd[pre + "self_attn.q_proj.weight"] = mat(g["H"] * dh, d)
        sd[pre + "self_attn.k_proj.weight"] = mat(g["KV"] * dh, d)
        sd[pre + "self_attn.v_proj.weight"] = mat(g["KV"] * dh, d)
        sd[pre + "self_attn.o_proj.weight"] = mat(d, g["H"] * dh)
        if g["arch"].startswith("Qwen2"):
            sd[pre + "self_attn.q_proj.bias"] = mat(g["H"] * dh)
            sd[pre + "self_attn.k_proj.bias"] = mat(g["KV"] * dh)
            sd[pre + "self_attn.v_proj.bias"] = mat(g["KV"] * dh)
        sd[pre + "mlp.gate_proj.weight"] = mat(F, d)
        sd[pre + "mlp.up_proj.weight"] = mat(F, d)
        sd[pre + "mlp.down_proj.weight"] = mat(d, F)
        # a buffer outside the name map, which both loaders skip
        sd[pre + "self_attn.rotary_emb.inv_freq"] = np.ones(dh // 2, np.float32)
    return sd


def write_hf_checkpoint(path, family, stored="F32", shards=1, seed=0, max_pos=2048):
    """A safetensors checkpoint of ``family`` under ``path``: one file, or
    ``shards`` files with an index; config.json beside it."""
    from safetensors.numpy import save_file

    g = GEOMETRY[family]
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    sd = hf_state_dict(family, stored, seed)
    names = list(sd)
    if shards == 1:
        save_file(sd, str(path / "model.safetensors"))
    else:
        weight_map = {}
        for s in range(shards):
            fname = f"model-{s + 1:05d}-of-{shards:05d}.safetensors"
            part = {n: sd[n] for n in names[s::shards]}
            save_file(part, str(path / fname))
            weight_map.update({n: fname for n in part})
        (path / "model.safetensors.index.json").write_text(
            json.dumps({"metadata": {}, "weight_map": weight_map}))
    cfg = {"architectures": [g["arch"]], "vocab_size": g["V"], "hidden_size": g["d"],
           "num_hidden_layers": g["L"], "num_attention_heads": g["H"],
           "num_key_value_heads": g["KV"], "head_dim": g["dh"], "intermediate_size": g["F"],
           "rope_theta": 10000.0 if g["tied"] else 500000.0,
           "rms_norm_eps": 1e-6 if g["tied"] else 1e-5,
           "tie_word_embeddings": g["tied"], "max_position_embeddings": max_pos}
    if g["rope_scaling"]:
        cfg["rope_scaling"] = g["rope_scaling"]
    (path / "config.json").write_text(json.dumps(cfg))
    return str(path)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for key in sorted(tree) for kv in _flat(tree[key], f"{prefix}{key}.")]
    return [(prefix[:-1], np.asarray(tree))]


def assert_trees_bit_equal(port_tree, ref_tree):
    got, want = _flat(bridge.to_numpy(port_tree)), _flat(jax.tree.map(np.asarray, ref_tree))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8), err_msg=path)


def _jspec(port_spec, dtype):
    """The reference's ModelSpec with the fields of the port's."""
    from tst.models.decoder import ModelSpec as JSpec

    return JSpec(**{**dataclasses.asdict(port_spec), "dtype": dtype})


DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.mark.parametrize("family,shards", [("qwen", 1), ("qwen", 3), ("llama", 1),
                                           ("llama", 2)])
@pytest.mark.parametrize("stored", ["F32", "BF16"])
def test_load_checkpoint_bit_equal(tmp_path, family, shards, stored):
    """The port's tree equals the reference's bit for bit, loaded in f32 and
    in bf16 (bf16 on disk is viewed as bf16 by the port, widened to f32 by
    the reference: the same values)."""
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", family, stored, shards)
    spec = thf.spec_from_hf_config(ckpt)
    for tdt, jdt in DTYPES:
        got = thf.load_checkpoint(ckpt, spec, dtype=tdt, device=CPU)
        want = jhf.load_checkpoint(ckpt, _jspec(spec, jdt), dtype=jdt)
        assert_trees_bit_equal(got, want)
        assert ("lm_head" in got) == (family == "llama")
        assert ("bq" in got["layers"]) == (family == "qwen")


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("family", ["qwen", "llama"])
def test_quantizing_put_bit_equal(tmp_path, family, bits):
    """Quantized on arrival: int8 per channel or int4 g128 planar nibbles on
    the layer matrices (embed and head int8), q and scale bit-equal to the
    reference's quantizing_put, in f32 and bf16."""
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", family, "BF16")
    spec = thf.spec_from_hf_config(ckpt)
    for tdt, jdt in DTYPES:
        got = thf.load_checkpoint(ckpt, spec, dtype=tdt, device=CPU,
                                  put=tquant.quantizing_put(tdt, bits=bits))
        want = jhf.load_checkpoint(ckpt, _jspec(spec, jdt), dtype=jdt,
                                   put=jquant.quantizing_put(jdt, bits=bits))
        assert_trees_bit_equal(got, want)
        assert tquant.is_int4_leaf(got["layers"]["w_gate"]) == (bits == 4)
        assert tquant.is_quantized_leaf(got["embed"]) and not tquant.is_int4_leaf(got["embed"])
        assert not tquant.is_quantized_leaf(got["layers"]["attn_norm"])


@pytest.mark.parametrize("family", ["qwen", "llama"])
def test_spec_from_hf_config_matches_reference(tmp_path, family):
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", family)
    got = dataclasses.asdict(thf.spec_from_hf_config(ckpt, name="x"))
    want = dataclasses.asdict(jhf.spec_from_hf_config(ckpt, name="x"))
    got.pop("dtype"), want.pop("dtype")
    assert got == want
    assert got["qkv_bias"] == (family == "qwen") and got["tie_embeddings"] == (family == "qwen")
    assert (got["rope_scaling"] is None) == (family == "qwen")


@pytest.mark.parametrize("kind", ["linear", "dynamic", "yarn"])
def test_unsupported_rope_scaling_raises(tmp_path, kind):
    ckpt = Path(write_hf_checkpoint(tmp_path / "ckpt", "llama"))
    cfg = json.loads((ckpt / "config.json").read_text())
    cfg["rope_scaling"] = {"type": kind, "factor": 2.0}
    (ckpt / "config.json").write_text(json.dumps(cfg))
    for mod in (thf, jhf):
        with pytest.raises(ValueError, match="unsupported rope_scaling type"):
            mod.spec_from_hf_config(str(ckpt))


def test_from_pretrained_shims(tmp_path):
    """llama.from_pretrained refuses a Qwen2 checkpoint, as the reference
    does; qwen2.from_pretrained loads it, bit-equal to the reference."""
    qwen = write_hf_checkpoint(tmp_path / "qwen", "qwen")
    llama = write_hf_checkpoint(tmp_path / "llama", "llama", "BF16")
    for mod in (tllama, jllama):
        kw = {"device": CPU} if mod is tllama else {}
        with pytest.raises(ValueError, match="looks like a Qwen2 checkpoint"):
            mod.from_pretrained(qwen, **kw)
    spec, params = tqwen2.from_pretrained(qwen, dtype=torch.float32, device=CPU)
    jspec, jparams = jqwen2.from_pretrained(qwen, dtype=jnp.float32)
    assert spec.name == jspec.name == "qwen2"
    assert_trees_bit_equal(params, jparams)
    spec, params = tllama.from_pretrained(llama, device=CPU)
    jspec, jparams = jllama.from_pretrained(llama)
    assert spec.name == "llama3" and spec.rope_scaling == jspec.rope_scaling
    assert_trees_bit_equal(params, jparams)
    assert params["layers"]["wq"].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", [(3, 5), (7,), (), (0, 4), (2, 3, 4)])
def test_reader_matches_safetensors(tmp_path, shape):
    """Every dtype the reader takes, against safetensors.numpy.load_file."""
    from safetensors.numpy import load_file, save_file

    rng = np.random.default_rng(len(shape))
    x = rng.normal(size=shape) * 3
    arrays = {name: np.asarray(a) for name, a in {
        "bf16": x.astype(np.float32).astype(ml_dtypes.bfloat16),
        "f16": x.astype(np.float16), "f32": x.astype(np.float32),
        "i8": rng.integers(-128, 128, size=shape).astype(np.int8),
        "u8": rng.integers(0, 256, size=shape).astype(np.uint8)}.items()}
    path = str(tmp_path / "t.safetensors")
    save_file(arrays, path, metadata={"format": "np"})
    want = load_file(path)
    sf = thf.SafetensorsFile(path)
    assert sorted(sf.keys()) == sorted(arrays)
    for name in arrays:
        got = bridge.leaf_to_numpy(sf.get(name))
        assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
        np.testing.assert_array_equal(got.reshape(-1).view(np.uint8),
                                      want[name].reshape(-1).view(np.uint8), err_msg=name)


def test_bad_checkpoints_raise(tmp_path):
    """A truncated file, an unknown dtype, a missing directory and a spec the
    checkpoint does not fit all raise; nothing loads part of a model."""
    from safetensors.numpy import save_file

    path = tmp_path / "t.safetensors"
    save_file({"x": np.ones((64, 64), np.float32)}, str(path))
    data = path.read_bytes()
    path.write_bytes(data[:-16])
    with pytest.raises(ValueError, match="want 16384"):
        thf.SafetensorsFile(str(path))
    save_file({"x": np.ones(4, np.float64)}, str(path))
    with pytest.raises(ValueError, match="dtype F64"):
        thf.SafetensorsFile(str(path))
    with pytest.raises(FileNotFoundError):
        thf.load_checkpoint(str(tmp_path / "none"), spec_by_name("llama3-8b"), device=CPU)
    ckpt = write_hf_checkpoint(tmp_path / "ckpt", "llama")
    spec = thf.spec_from_hf_config(ckpt)
    with pytest.raises(ValueError, match="wq"):
        thf.load_checkpoint(ckpt, dataclasses.replace(spec, n_heads=8), device=CPU)
    with pytest.raises(ValueError, match="layer 2 outside"):
        thf.load_checkpoint(ckpt, dataclasses.replace(spec, n_layers=2), device=CPU)
    with pytest.raises(ValueError, match="qkv biases"):
        thf.load_checkpoint(ckpt, dataclasses.replace(spec, qkv_bias=True), device=CPU)


@pytest.mark.parametrize("drop, match", [
    (["model.layers.1.mlp.up_proj.weight"], r"no w_up for layers \[1\] of 3"),
    ([f"model.layers.2.{n}" for n in ("input_layernorm.weight", "self_attn.q_proj.weight",
                                      "self_attn.k_proj.weight", "self_attn.v_proj.weight",
                                      "self_attn.o_proj.weight",
                                      "post_attention_layernorm.weight",
                                      "mlp.gate_proj.weight", "mlp.up_proj.weight",
                                      "mlp.down_proj.weight")],
     r"no attn_norm for layers \[2\] of 3"),
    ([f"model.layers.{i}.mlp.down_proj.weight" for i in range(3)],
     r"no w_down for layers \[0, 1, 2\] of 3"),
], ids=["one-tensor", "one-layer", "one-family"])
def test_missing_layers_raise(tmp_path, drop, match):
    """A checkpoint that lacks a tensor, a whole layer (fewer layers than
    its config.json) or a whole family raises, sharded or not; no layer
    buffer is handed on with slices that never arrived."""
    from safetensors.numpy import save_file

    ckpt = Path(write_hf_checkpoint(tmp_path / "ckpt", "llama"))
    sd = hf_state_dict("llama")
    for name in drop:
        del sd[name]
    save_file(sd, str(ckpt / "model.safetensors"))
    spec = thf.spec_from_hf_config(str(ckpt))
    with pytest.raises(ValueError, match=match):
        thf.load_checkpoint(str(ckpt), spec, device=CPU)
    with pytest.raises(ValueError, match=match):
        thf.load_checkpoint(str(ckpt), spec, put=tquant.quantizing_put(torch.float32, bits=4),
                            device=CPU)


def test_build_model_loads_the_path(tmp_path):
    """``model.path``: the spec from config.json in the run's dtype, the
    weights the loader's; ``model.quantize`` streams
    through quantizing_put. The reference's build_model gives the same."""
    from tst import config as jconfig
    from tst.data.tokenize import ByteTokenizer as JByte
    from tst.train import pipeline as jpipe
    from tst_torch import config as tconfig
    from tst_torch.data.tokenize import ByteTokenizer
    from tst_torch.train import pipeline as tpipe

    ckpt = write_hf_checkpoint(tmp_path / "ckpt", "qwen", "BF16")
    for quant in ("none", "int8", "int4"):
        over = [f"model.path={ckpt}", "model.dtype=float32", f"model.quantize={quant}"]
        spec, params = tpipe.build_model(tconfig.resolve(None, None, over), ByteTokenizer(), CPU)
        jspec, jparams = jpipe.build_model(jconfig.resolve(None, None, over), JByte())
        assert spec.dtype == torch.float32 and spec.vocab_size == 384
        assert spec.name == jspec.name == "tiny"
        assert_trees_bit_equal(params, jparams)


_RSS_SNIPPET = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from tst_torch.models.hf_load import load_checkpoint, spec_from_hf_config


def status_kib(key):
    with open("/proc/self/status") as f:
        return next(int(ln.split()[1]) for ln in f if ln.startswith(key + ":"))


spec = spec_from_hf_config({ckpt!r})
with open("/proc/self/clear_refs", "w") as f:
    f.write("5")  # resets the peak resident set (VmHWM) to the current one
base = status_kib("VmRSS")
params = load_checkpoint({ckpt!r}, spec, device=torch.device("cpu"))
peak = status_kib("VmHWM")
print(json.dumps({{"base_kib": base, "peak_kib": peak,
                   "model_bytes": sum(t.numel() * t.element_size() for t in
                                      [params["embed"], params["lm_head"], params["final_norm"],
                                       *params["layers"].values()])}}))
"""


def test_peak_host_memory_is_one_tensor(tmp_path):
    """Loading a bf16 checkpoint into bf16 CPU tensors raises the process's
    peak resident set (VmHWM, reset before the load) by the model (the
    CPU's "device" buffers are host memory) plus about one tensor: 16
    layers of 2 MiB tensors, 130 MB in all, with 40 MB of slack. A loader
    that read the whole file, or built host stacks before copying them out,
    would grow by twice the model."""
    from safetensors.numpy import save_file

    d, layers, h, kv, dh, f, v = 512, 16, 8, 2, 64, 2048, 4096
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    rng = np.random.default_rng(0)

    def mat(*shape):
        return rng.standard_normal(shape, np.float32).astype(ml_dtypes.bfloat16)

    sd = {"model.embed_tokens.weight": mat(v, d), "lm_head.weight": mat(v, d),
          "model.norm.weight": mat(d)}
    for i in range(layers):
        pre = f"model.layers.{i}."
        sd.update({pre + "input_layernorm.weight": mat(d),
                   pre + "post_attention_layernorm.weight": mat(d),
                   pre + "self_attn.q_proj.weight": mat(h * dh, d),
                   pre + "self_attn.k_proj.weight": mat(kv * dh, d),
                   pre + "self_attn.v_proj.weight": mat(kv * dh, d),
                   pre + "self_attn.o_proj.weight": mat(d, h * dh),
                   pre + "mlp.gate_proj.weight": mat(f, d), pre + "mlp.up_proj.weight": mat(f, d),
                   pre + "mlp.down_proj.weight": mat(d, f)})
    save_file(sd, str(ckpt / "model.safetensors"))
    largest = max(a.nbytes for a in sd.values())
    del sd
    (ckpt / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "vocab_size": v, "hidden_size": d,
        "num_hidden_layers": layers, "num_attention_heads": h, "num_key_value_heads": kv,
        "intermediate_size": f, "tie_word_embeddings": False}))
    proc = subprocess.run([sys.executable, "-c", _RSS_SNIPPET.format(repo=str(REPO),
                                                                     ckpt=str(ckpt))],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    growth = (out["peak_kib"] - out["base_kib"]) * 1024
    model = out["model_bytes"]
    assert model > 0.12e9 and largest <= 4.2e6
    assert growth < model + 40e6, (f"load grew the process by {growth / 1e6:.1f} MB for a "
                                   f"{model / 1e6:.1f} MB model")
