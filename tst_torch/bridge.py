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
Neither jax nor ml_dtypes is imported here.
"""

from __future__ import annotations

from typing import Any, Dict, Union

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
