"""Parameter trees between the JAX package and the port, through numpy.

The JAX tree is nested dicts of arrays (``tst/models/decoder.py:196-219``:
stacked ``[L, ...]`` layer leaves); the port keeps the same keys and shapes
with torch tensors as leaves. LoRA adapter trees cross the same way, single
(``{proj: {"a": [L, r, in], "b": [L, out, r]}}``) or fold-stacked as
``FoldTrainer.init_state`` makes them (``[k, L, ...]`` leaves): that is how
a test gives both packages the same adapters, since ``jax.random`` streams
cannot be reproduced in torch. Quantized ``{"q", "scale"}`` leaves
(tst.models.quant: int8 ``q`` and f32 scales, int8 or packed int4) cross
as the two tensors they are, bit for bit. bf16 leaves keep their bits: ``np.asarray`` of
a bf16 JAX array has the ``bfloat16`` dtype of ml_dtypes, which
``torch.from_numpy`` refuses, so its raw 16-bit words are reinterpreted.
:func:`save_adapter_checkpoint` writes a JAX adapter checkpoint, read
back as numpy, in the port's checkpoint format. Neither jax nor ml_dtypes
is imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

Tree = Union[Dict[str, Any], Any]


def leaf_to_torch(a, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # owned and writable, as torch wants
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        # the bfloat16 numpy dtype exists only once ml_dtypes is loaded (it is
        # wherever a JAX tree is being compared)
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def to_torch(tree: Tree, device: Union[str, torch.device] = "cpu") -> Tree:
    """JAX/numpy parameter tree → the port's tree of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return leaf_to_torch(tree, device)


def to_numpy(tree: Tree) -> Tree:
    """The port's tree of tensors → nested dicts of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return leaf_to_numpy(tree)


def save_adapter_checkpoint(path: str, lora: Tree, mu: Tree, nu: Tree, count: int,
                            extra: Optional[Dict[str, Any]] = None) -> None:
    """A JAX package adapter checkpoint, given as numpy trees (its fold-stacked
    adapters and AdamW moments, the optimizer's step ``count`` and its
    ``extra.json`` stamp, as ``tst.aux.ckpt.load_train_state`` restores
    them), written in the port's checkpoint format
    (``tst_torch.aux.ckpt.save_train_state``), bit for bit, so the port
    serves or resumes it."""
    from tst_torch.aux.ckpt import save_train_state
    from tst_torch.train.sft import AdamWState

    save_train_state(path, to_torch(lora), AdamWState(int(count), to_torch(mu), to_torch(nu)),
                     extra=extra)
