"""Qwen2 / Qwen2.5 model family (counterpart of ``tst/models/qwen2.py``):
the decoder core is tst_torch.models.decoder; the family's differences are
QKV biases, tied embeddings (0.5B) and rope_theta 1e6."""

from __future__ import annotations

from tst_torch.models.hf_load import load_checkpoint, spec_from_hf_config


def from_pretrained(ckpt_dir: str, dtype=None, put=None, *, device):
    """(spec, params on ``device``) from a local HF Qwen2 checkpoint directory."""
    s = spec_from_hf_config(ckpt_dir, name="qwen2")
    return s, load_checkpoint(ckpt_dir, s, dtype=dtype, put=put, device=device)
