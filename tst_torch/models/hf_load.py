"""HF safetensors checkpoint → the stacked-layer parameter tree, streamed
(counterpart of ``tst/models/hf_load.py``).

Tensors are read one at a time by the port's own safetensors reader (an
8-byte little-endian header length, a JSON header of dtype, shape and
``data_offsets``, then the raw bytes; the ``safetensors`` package is not
used), moved to the run's device, transposed there from HF's ``[out, in]``
to ``[in, out]``, converted or quantized by ``put``, and copied into a
``[L, ...]`` buffer preallocated on the device at the family's first
layer. Peak host memory is one tensor, never the model.

Name mapping covers the Llama and Qwen2 families (``LlamaForCausalLM``,
``Qwen2ForCausalLM``).
"""

from __future__ import annotations

import glob
import json
import math
import os
import struct
from typing import Any, Callable, Dict, Iterator, Mapping, Optional, Tuple

import torch

from tst_torch.models.quant import leaf_logical_shape
from tst_torch.models.spec import ModelSpec

Params = Dict[str, Any]

#: HF tensor name templates → (our path, needs_transpose). {i} = layer index.
_LAYER_MAP = {
    "model.layers.{i}.input_layernorm.weight": ("attn_norm", False),
    "model.layers.{i}.self_attn.q_proj.weight": ("wq", True),
    "model.layers.{i}.self_attn.k_proj.weight": ("wk", True),
    "model.layers.{i}.self_attn.v_proj.weight": ("wv", True),
    "model.layers.{i}.self_attn.o_proj.weight": ("wo", True),
    "model.layers.{i}.self_attn.q_proj.bias": ("bq", False),
    "model.layers.{i}.self_attn.k_proj.bias": ("bk", False),
    "model.layers.{i}.self_attn.v_proj.bias": ("bv", False),
    "model.layers.{i}.post_attention_layernorm.weight": ("mlp_norm", False),
    "model.layers.{i}.mlp.gate_proj.weight": ("w_gate", True),
    "model.layers.{i}.mlp.up_proj.weight": ("w_up", True),
    "model.layers.{i}.mlp.down_proj.weight": ("w_down", True),
}
_TOP_MAP = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}

#: safetensors dtype name → torch dtype (bf16 arrives as its raw 16-bit words)
SAFETENSORS_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
                      "I8": torch.int8, "U8": torch.uint8}


class SafetensorsFile:
    """One ``.safetensors`` file: its header on opening, then one tensor a
    :meth:`get`, read with ``readinto`` into a host buffer of that tensor's
    bytes and nothing more."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (no header length)")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(f.fileno()).st_size
            if 8 + n > size:
                raise ValueError(f"{path}: header of {n} bytes runs past the file's {size}")
            header = json.loads(f.read(n))
        self.data_start = 8 + n
        #: the header's string-to-string ``__metadata__`` (empty when absent)
        self.metadata: Dict[str, str] = header.pop("__metadata__", None) or {}
        self.entries: Dict[str, Tuple[torch.dtype, Tuple[int, ...], int, int]] = {}
        for name, e in header.items():
            if e["dtype"] not in SAFETENSORS_DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e['dtype']}; the reader takes "
                                 f"{sorted(SAFETENSORS_DTYPES)}")
            dtype, shape = SAFETENSORS_DTYPES[e["dtype"]], tuple(int(d) for d in e["shape"])
            begin, end = (int(o) for o in e["data_offsets"])
            want = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            if end - begin != want or self.data_start + end > size:
                raise ValueError(f"{path}: {name} {e['dtype']}{list(shape)} has bytes "
                                 f"[{begin}, {end}), want {want} inside the file's {size}")
            self.entries[name] = (dtype, shape, begin, end)

    def keys(self):
        return self.entries.keys()

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name``, a new CPU tensor of the stored dtype."""
        dtype, shape, begin, end = self.entries[name]
        buf = torch.empty(end - begin, dtype=torch.uint8)
        view = memoryview(buf.numpy())
        with open(self.path, "rb", buffering=0) as f:
            f.seek(self.data_start + begin)
            got = 0
            while got < len(view):  # one read(2) returns at most ~2 GiB
                n = f.readinto(view[got:])
                if not n:
                    raise ValueError(f"{self.path}: {name} ends after {got} of "
                                     f"{len(view)} bytes")
                got += n
        return buf.view(dtype).reshape(shape)


class LazyStateDict(Mapping):
    """name → tensor over every ``*.safetensors`` file of a directory (one
    file, or the shards of ``model.safetensors.index.json``); a tensor is
    read when it is asked for."""

    def __init__(self, ckpt_dir: str):
        paths = sorted(glob.glob(os.path.join(ckpt_dir, "*.safetensors")))
        if not paths:
            raise FileNotFoundError(f"no .safetensors files under {ckpt_dir}")
        self._file_of: Dict[str, SafetensorsFile] = {}
        for path in paths:
            sf = SafetensorsFile(path)
            for name in sf.keys():
                self._file_of[name] = sf

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._file_of[name].get(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._file_of)

    def __len__(self) -> int:
        return len(self._file_of)


def _stacked_empty_like(sl, n_layers: int):
    """A device buffer [L, ...] for a [1, ...] slice (plain or {"q", "scale"})."""
    if isinstance(sl, dict):
        return {key: _stacked_empty_like(t, n_layers) for key, t in sl.items()}
    return torch.empty((n_layers,) + tuple(sl.shape[1:]), dtype=sl.dtype, device=sl.device)


def _write_slice(buf, sl, i: int) -> None:
    if isinstance(sl, dict):
        for key in sl:
            _write_slice(buf[key], sl[key], i)
    else:
        buf[i].copy_(sl[0])


def convert_state_dict(
    sd: Mapping[str, torch.Tensor],
    spec: ModelSpec,
    dtype: Optional[torch.dtype] = None,
    put: Optional[Callable[[str, torch.Tensor], Any]] = None,
    *,
    device,
    mesh=None,
) -> Params:
    """An HF state dict (name → tensor) → the parameter tree on ``device``,
    streamed: each tensor moves to ``device`` as it arrives, is transposed
    there where HF stores ``[out, in]``, and goes through ``put(path, t)``
    (default: a cast to ``dtype``, else ``spec.dtype``). A layer tensor
    reaches ``put`` as a ``[1, ...]`` slice, so a quantizing ``put`` sees
    the rank of the stacked leaf, and is copied into a ``[L, ...]`` buffer
    allocated on the device at the family's first layer. A tied head and
    any tensor outside the name maps (rotary buffers) are skipped. Raises
    unless every layer of every family the spec needs arrived. ``mesh``
    (tst_torch.runtime.mesh): each tensor is cut to this rank's slice as it
    arrives (``shard_leaf``), so a rank holds only its shard; the widths are
    then checked by the cut."""
    dt = dtype or spec.dtype
    put = put or (lambda path, t: t.to(dtype=dt))
    from tst_torch.runtime import mesh as mesh_mod

    if mesh_mod.active(mesh):
        whole_put = put

        def put(path, t):
            leaf = whole_put(path, t)
            return mesh_mod.shard_leaf(leaf, mesh_mod.leaf_pspec(path, leaf), mesh, path)
    device = torch.device(device)
    n_layers = spec.n_layers
    layers: Dict[str, Any] = {}
    written: Dict[str, set] = {}
    params: Params = {}

    def arrive(tensor: torch.Tensor, transpose: bool) -> torch.Tensor:
        t = tensor.to(device)
        return t.T if transpose else t

    for name in sd:
        if name == "lm_head.weight" and spec.tie_embeddings:
            continue  # tied checkpoints reuse embed
        hit = _TOP_MAP.get(name)
        if hit:
            path, transpose = hit
            params[path] = _contiguous(put(path, arrive(sd[name], transpose)))
            continue
        parts = name.split(".")
        if len(parts) > 2 and parts[1] == "layers":
            hit = _LAYER_MAP.get(".".join(parts[:2] + ["{i}"] + parts[3:]))
            if hit is None:
                continue  # e.g. rotary inv_freq buffers
            key, transpose = hit
            i = int(parts[2])
            if not 0 <= i < n_layers:
                raise ValueError(f"{name}: layer {i} outside the spec's {n_layers} layers")
            sl = put(f"layers.{key}", arrive(sd[name], transpose)[None])
            if key not in layers:
                layers[key] = _stacked_empty_like(sl, n_layers)
            _write_slice(layers[key], sl, i)
            written.setdefault(key, set()).add(i)
    params["layers"] = {key: layers[key] for key in sorted(layers)}
    _check_shapes(params, spec, written, widths=not mesh_mod.active(mesh))
    return params


def _contiguous(leaf):
    if isinstance(leaf, dict):
        return {key: t.contiguous() for key, t in leaf.items()}
    return leaf.contiguous()


#: the layer families every checkpoint holds (Qwen2 adds the QKV biases)
_LAYER_FAMILIES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate", "w_up", "w_down")


def _check_shapes(params: Params, spec: ModelSpec, written: Mapping[str, set],
                  widths: bool = True) -> None:
    """Raises where ``params`` does not fit ``spec``, or where a layer of a
    family the spec needs never arrived (``written``: family → the layer
    indices copied into its buffer, which holds uninitialized memory
    elsewhere). ``widths=False`` (a rank's shards) checks the families
    only."""
    expect = {"embed": (spec.vocab_size, spec.d_model), "final_norm": (spec.d_model,)}
    for key, shape in expect.items():
        if key not in params:
            raise ValueError(f"checkpoint has no {key}")
        got = leaf_logical_shape(params[key])
        if widths and got != shape:
            raise ValueError(f"{key}: shape {got} != spec {shape}")
    if "wq" not in params["layers"]:
        raise ValueError("checkpoint has no layers")
    wq = leaf_logical_shape(params["layers"]["wq"])
    if widths and wq != (spec.n_layers, spec.d_model, spec.q_dim):
        raise ValueError(f"wq: {wq} != {(spec.n_layers, spec.d_model, spec.q_dim)}")
    if spec.qkv_bias and "bq" not in params["layers"]:
        raise ValueError("spec expects qkv biases but checkpoint has none")
    if not spec.tie_embeddings and "lm_head" not in params:
        raise ValueError("spec has an untied head but the checkpoint has no lm_head")
    families = _LAYER_FAMILIES + (("bq", "bk", "bv") if spec.qkv_bias else ())
    for key in families:
        missing = sorted(set(range(spec.n_layers)) - written.get(key, set()))
        if missing:
            raise ValueError(f"checkpoint has no {key} for layers {missing} of "
                             f"{spec.n_layers}")


def load_checkpoint(
    ckpt_dir: str,
    spec: ModelSpec,
    dtype: Optional[torch.dtype] = None,
    put: Optional[Callable[[str, torch.Tensor], Any]] = None,
    *,
    device,
    mesh=None,
) -> Params:
    """Stream a safetensors checkpoint directory (one file, or the sharded
    ``model.safetensors.index.json`` layout) into the parameter tree on
    ``device`` (:func:`convert_state_dict`; ``mesh``: this rank's shards);
    raises on a checkpoint that does not read or does not fit ``spec``."""
    return convert_state_dict(LazyStateDict(ckpt_dir), spec, dtype=dtype, put=put,
                              device=device, mesh=mesh)


def spec_from_hf_config(ckpt_dir: str, name: str = "custom") -> ModelSpec:
    """A ModelSpec from an HF ``config.json`` (local directory): QKV biases
    for Qwen2 architectures, llama3 RoPE scaling; any other scaling type
    raises ValueError."""
    with open(os.path.join(ckpt_dir, "config.json")) as f:
        cfg = json.load(f)
    arch = (cfg.get("architectures") or ["?"])[0]
    rs = cfg.get("rope_scaling")
    rope_scaling = None
    if rs:
        kind = rs.get("rope_type", rs.get("type"))
        if kind != "llama3":
            raise ValueError(f"unsupported rope_scaling type {kind!r} (supported: llama3)")
        rope_scaling = ("llama3", float(rs["factor"]), float(rs["low_freq_factor"]),
                        float(rs["high_freq_factor"]),
                        int(rs["original_max_position_embeddings"]))
    return ModelSpec(
        name=name,
        vocab_size=cfg["vocab_size"],
        d_model=cfg["hidden_size"],
        n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg.get("num_key_value_heads", cfg["num_attention_heads"]),
        d_head=cfg.get("head_dim", cfg["hidden_size"] // cfg["num_attention_heads"]),
        d_ff=cfg["intermediate_size"],
        rope_theta=cfg.get("rope_theta", 10000.0),
        rms_eps=cfg.get("rms_norm_eps", 1e-6),
        qkv_bias="Qwen2" in arch,
        tie_embeddings=cfg.get("tie_word_embeddings", False),
        max_seq_len=cfg.get("max_position_embeddings", 32768),
        rope_scaling=rope_scaling,
    )

