"""tst_torch — the PyTorch / CUDA port of ``tst`` for one NVIDIA H100.

The JAX package ``tst`` stays the reference. This package imports torch and
numpy and never jax, and nothing of ``tst``: it keeps its own copies of the
jax-free host code it needs (config, data loading, tokenization, folds,
output writers, the run log), under ``tst``'s module names; every function
that calls jax is rewritten here, and every Pallas kernel on a ported path becomes a kernel
written by hand for Hopper (``tst_torch/csrc``).
"""

__version__ = "0.1.0"
