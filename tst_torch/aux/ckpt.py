"""Training checkpoints: the adapters and the AdamW state, never the frozen
base (counterpart of ``tst/aux/ckpt.py:32,52``).

The reference writes Orbax, which needs jax; the port writes its own
format, a directory of two files:

  * ``state.safetensors``: every adapter leaf as ``lora.<proj>.<a|b>`` and
    the AdamW moments as ``opt.mu.<proj>.<a|b>`` and ``opt.nu.<proj>.<a|b>``
    (fold-stacked ``[k, L, ...]`` leaves as they are), in the safetensors
    layout: an 8-byte little-endian header length, a JSON header, the raw
    bytes. The optimizer's step ``count`` rides in the header's
    ``__metadata__``. bf16 and f32 leaves keep their bits. The file is
    written here and read by ``tst_torch.models.hf_load.SafetensorsFile``;
    the ``safetensors`` package is not used.
  * ``extra.json``: the host metadata the caller stamps, as in the
    reference (``FoldTrainer.ckpt_extra(step=...)``: k, model name, LoRA
    geometry, step).

A save is atomic: both files go into a temporary directory beside the
target, which replaces the target by a rename, as Orbax commits. A save that
fails midway leaves the previous checkpoint as it was. Reading the JAX
package's Orbax checkpoints is not a goal; ``tst_torch.bridge`` converts
their numpy leaves into this format. A load reads into the run's trees,
each leaf checked against the file.

The XLA compilation cache of the reference's module has no counterpart:
eager torch compiles no programs.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import tempfile
from typing import Any, Dict, Optional, Tuple

import torch

from tst_torch.models.hf_load import SafetensorsFile

STATE_FILE = "state.safetensors"
EXTRA_FILE = "extra.json"
#: torch dtype → safetensors dtype name (the leaves an adapter state holds)
_DTYPE_NAMES = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dicts of tensors → {"a.b.c": tensor}, keys sorted."""
    if isinstance(tree, dict):
        out: Dict[str, torch.Tensor] = {}
        for key in sorted(tree):
            out.update(flatten(tree[key], f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tree}


def unflatten(flat: Dict[str, torch.Tensor]):
    """The inverse of :func:`flatten`."""
    tree: Dict[str, Any] = {}
    for name, t in flat.items():
        node = tree
        *path, last = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[last] = t
    return tree


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (bf16, f16 or f32, any device) as one safetensors
    file, in the order given, flushed to the disk before returning."""
    header: Dict[str, Any] = {"__metadata__": dict(metadata or {})}
    blobs, offset = [], 0
    for name, t in tensors.items():
        if t.dtype not in _DTYPE_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype}, want one of "
                             f"{sorted(map(str, _DTYPE_NAMES))}")
        raw = t.detach().contiguous().cpu().view(torch.uint8).reshape(-1).numpy().tobytes()
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * ((-len(head)) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
        f.flush()
        os.fsync(f.fileno())


def save_train_state(path: str, lora, opt_state, extra: Optional[Dict[str, Any]] = None) -> None:
    """Checkpoint (adapters, AdamW state, host metadata) into the directory
    ``path``, replacing what it held, atomically. The frozen base is never
    checkpointed."""
    path = os.path.abspath(path)
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tensors = flatten({"lora": lora, "opt": {"mu": opt_state.mu, "nu": opt_state.nu}})
    tmp = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", suffix=".tmp", dir=parent)
    try:
        write_safetensors(os.path.join(tmp, STATE_FILE), tensors,
                          {"format": "tst_torch-train-state", "count": str(int(opt_state.count))})
        if extra is not None:
            with open(os.path.join(tmp, EXTRA_FILE), "w") as f:
                json.dump(extra, f, default=float)
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{os.path.basename(path)}.", suffix=".old",
                                   dir=parent)
            os.rename(path, os.path.join(old, "ckpt"))
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def load_train_state(path: str, like_lora,
                     like_opt_state=None) -> Tuple[Any, Any, Optional[dict]]:
    """Restore (lora, opt_state, extra) from :func:`save_train_state`'s
    directory into the run's trees: ``like_lora`` (and ``like_opt_state``,
    an ``AdamWState``; without it only the adapters are read and opt_state
    is None) give each leaf's name, shape, device and dtype. Names or
    shapes that differ from the file's raise ValueError; a leaf of another
    dtype is cast, as Orbax restores into its target's dtype (the same
    dtype keeps its bits)."""
    from tst_torch.train.sft import AdamWState

    path = os.path.abspath(path)
    sf = SafetensorsFile(os.path.join(path, STATE_FILE))
    like = flatten({"lora": like_lora})
    if like_opt_state is not None:
        like.update(flatten({"opt": {"mu": like_opt_state.mu, "nu": like_opt_state.nu}}))
    want = {n for n in sf.keys() if like_opt_state is not None or n.startswith("lora.")}
    if set(like) != want:
        raise ValueError(f"{path}: checkpoint leaves {sorted(want)} differ from the run's "
                         f"{sorted(like)}")
    flat = {}
    for name, t in like.items():
        got = sf.get(name)
        if got.shape != t.shape:
            raise ValueError(f"{path}: {name} has shape {list(got.shape)}, the run's "
                             f"{list(t.shape)}")
        flat[name] = got.to(t.device, t.dtype)
    tree = unflatten(flat)
    opt = None
    if like_opt_state is not None:
        opt = AdamWState(int(sf.metadata["count"]), tree["opt"]["mu"], tree["opt"]["nu"])
    extra = None
    extra_path = os.path.join(path, EXTRA_FILE)
    if os.path.exists(extra_path):
        with open(extra_path) as f:
            extra = json.load(f)
    return tree["lora"], opt, extra
