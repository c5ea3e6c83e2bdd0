"""Llama-3 model family (counterpart of ``tst/models/llama.py``): the
decoder core is tst_torch.models.decoder; this module holds the family's
checkpoint conventions (no QKV biases, untied head, rope_theta 5e5)."""

from __future__ import annotations

from tst_torch.models.hf_load import load_checkpoint, spec_from_hf_config


def from_pretrained(ckpt_dir: str, dtype=None, put=None, *, device):
    """(spec, params on ``device``) from a local HF Llama checkpoint directory."""
    s = spec_from_hf_config(ckpt_dir, name="llama3")
    if s.qkv_bias:
        raise ValueError(f"{ckpt_dir} looks like a Qwen2 checkpoint, not Llama")
    return s, load_checkpoint(ckpt_dir, s, dtype=dtype, put=put, device=device)
