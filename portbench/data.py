"""The benchmark's inputs, all drawn from ``--seed``: the base weights, the
adapters, the rows (token ids, answer positions, target masks), the folds
and the order in which the window visits the rows.

Every seed gives the same shapes, the same number of rows and the same
number of target tokens' slots; a seed changes values and order only, so two
seeds ask the same work of the card. Weights and rows are drawn on the run's
device by a ``torch.Generator`` in a few large calls, in the type they are
served in (bf16); index orders on the host by numpy.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from portbench.flops import widths

_MASK64 = (1 << 64) - 1


def substream(seed: int, tag: int) -> int:
    """A 63-bit generator seed for the part ``tag`` of the inputs of
    ``seed`` (splitmix64's finalizer over both), so the parts are drawn
    apart and any seed, large or negative, is taken."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(tag) * 0xD1B54A32D192ED03 + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def generator(device: torch.device, seed: int, tag: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(substream(seed, tag))


#: the layer leaves of the port's parameter tree (stacked on a leading layer
#: axis, linear weights [in, out]) → (shape of one layer, fan-in or a kind)
def _layer_leaves(w: Mapping[str, int], qkv_bias: bool) -> Dict[str, tuple]:
    d, q, kv, f = w["d"], w["q"], w["kv"], w["f"]
    leaves = {"attn_norm": ((d,), "norm"), "wq": ((d, q), d), "wk": ((d, kv), d),
              "wv": ((d, kv), d), "wo": ((q, d), q), "mlp_norm": ((d,), "norm"),
              "w_gate": ((d, f), d), "w_up": ((d, f), d), "w_down": ((f, d), f)}
    if qkv_bias:
        leaves.update({"bq": ((q,), "bias"), "bk": ((kv,), "bias"), "bv": ((kv,), "bias")})
    return leaves


def qkv_bias(cfg: Mapping) -> bool:
    return bool(cfg.get("attention_bias", cfg.get("model_type") == "qwen2"))


def torch_dtype(cfg: Mapping) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[cfg.get("torch_dtype", "bfloat16")]


def make_weights(cfg: Mapping, seed: int, device: torch.device) -> Dict:
    """The base weights in the port's tree layout: one normal draw over
    every leaf at once, each leaf a view of it scaled by 1/sqrt(fan-in);
    norm weights 1 + 0.1·N(0, 1), biases 0.02·N(0, 1). The embedding is
    [V, d] / sqrt(d); an untied head [d, V] / sqrt(d)."""
    w = widths(cfg)
    dt = torch_dtype(cfg)
    L, d, v = w["L"], w["d"], w["V"]
    leaves = {("layers", k): ((L,) + shape, kind)
              for k, (shape, kind) in _layer_leaves(w, qkv_bias(cfg)).items()}
    leaves[("embed",)] = ((v, d), d)
    leaves[("final_norm",)] = ((d,), "norm")
    if not cfg.get("tie_word_embeddings", False):
        leaves[("lm_head",)] = ((d, v), d)
    total = sum(math.prod(shape) for shape, _ in leaves.values())
    flat = torch.empty(total, dtype=dt, device=device)
    flat.normal_(generator=generator(device, seed, 1))
    tree: Dict = {"layers": {}}
    off = 0
    for key, (shape, kind) in leaves.items():
        n = math.prod(shape)
        leaf = flat[off: off + n].view(shape)
        off += n
        if kind == "norm":
            leaf.mul_(0.1).add_(1.0)
        elif kind == "bias":
            leaf.mul_(0.02)
        else:
            leaf.mul_(1.0 / math.sqrt(kind))
        if key[0] == "layers":
            tree["layers"][key[1]] = leaf
        else:
            tree[key[0]] = leaf
    return tree


def lora_shapes(cfg: Mapping, lora: Mapping) -> Dict[str, Dict[str, tuple]]:
    """{proj: {"a": (L, r, in), "b": (L, out, r)}} of one adapter, the
    port's layout and projection names."""
    w = widths(cfg)
    dims = {"q_proj": ("q", w["d"], w["q"]), "k_proj": ("k", w["d"], w["kv"]),
            "v_proj": ("v", w["d"], w["kv"]), "o_proj": ("o", w["q"], w["d"]),
            "gate_proj": ("gate", w["d"], w["f"]), "up_proj": ("up", w["d"], w["f"]),
            "down_proj": ("down", w["f"], w["d"])}
    r = int(lora["rank"])
    return {dims[t][0]: {"a": (w["L"], r, dims[t][1]), "b": (w["L"], dims[t][2], r)}
            for t in lora["targets"]}


def make_adapters(cfg: Mapping, lora: Mapping, folds: int, seed: int,
                  device: torch.device) -> Dict:
    """k fold-stacked adapters {proj: {"a": [k, L, r, in], "b": [k, L, out,
    r]}} in the model's type: A ~ N(0, 1)/sqrt(in), B ~ ``b_init_std``·N(0,
    1) (0: B starts at zero, as a new adapter does)."""
    dt = torch_dtype(cfg)
    g = generator(device, seed, 2)
    out = {}
    for proj, shp in lora_shapes(cfg, lora).items():
        a = torch.empty((folds,) + shp["a"], dtype=dt, device=device)
        a.normal_(generator=g).mul_(1.0 / math.sqrt(shp["a"][-1]))
        b = torch.zeros((folds,) + shp["b"], dtype=dt, device=device)
        if float(lora.get("b_init_std", 0.0)):
            b.normal_(generator=g).mul_(float(lora["b_init_std"]))
        out[proj] = {"a": a, "b": b}
    return out


@dataclasses.dataclass
class Rows:
    """A pool of rows: ``tokens`` int32 [N, S], ``answer_pos`` int64 [N]
    (the last prompt token), ``loss_mask`` f32 [N, S] (1 on the target
    tokens, which start at answer_pos + 1), ``fold_id`` int [N] (host),
    ``n_options`` int [N] (host) and the option letters' token ids."""

    tokens: torch.Tensor
    answer_pos: torch.Tensor
    loss_mask: torch.Tensor
    fold_id: np.ndarray
    n_options: np.ndarray
    option_ids: np.ndarray


def make_rows(cfg: Mapping, traffic: Mapping, n: int, seed: int,
              device: torch.device) -> Rows:
    """``n`` rows of ``seq_len`` tokens: a prompt of a length drawn from
    ``prompt_len`` (ids drawn over the vocabulary), the target (the gold
    option letter, then ids over the vocabulary, ``target_len`` tokens in
    all), then padding (id 0). Fold ids run 0..k-1 over the rows, so every
    fold holds n/k of them."""
    w = widths(cfg)
    s = int(traffic["seq_len"])
    g = generator(device, seed, 3)
    rng = np.random.default_rng(substream(seed, 4))
    lo, hi = (int(x) for x in traffic["prompt_len"])
    t_lo, t_hi = (int(x) for x in traffic.get("target_len", (1, 1)))
    if hi + t_hi > s:
        raise ValueError(f"prompts up to {hi} and targets up to {t_hi} tokens do not fit "
                         f"rows of {s}")
    letters = int(traffic["letters"])
    option_ids = rng.choice(w["V"], size=letters, replace=False).astype(np.int64)
    n_lo, n_hi = (int(x) for x in traffic.get("n_options", (letters, letters)))
    n_options = rng.integers(n_lo, n_hi + 1, size=n)
    plen = torch.randint(lo, hi + 1, (n,), generator=g, device=device)
    tlen = torch.randint(t_lo, t_hi + 1, (n,), generator=g, device=device)
    gold = torch.from_numpy(rng.integers(0, n_options)).to(device)
    tokens = torch.randint(0, w["V"], (n, s), generator=g, device=device, dtype=torch.int32)
    pos = torch.arange(s, device=device)[None, :]
    target = (pos >= plen[:, None]) & (pos < (plen + tlen)[:, None])
    tokens = torch.where(pos < (plen + tlen)[:, None], tokens, torch.zeros_like(tokens))
    letter = torch.from_numpy(option_ids).to(device)[gold].to(torch.int32)
    tokens[torch.arange(n, device=device), plen] = letter
    return Rows(tokens=tokens.contiguous(), answer_pos=(plen - 1).long(),
                loss_mask=target.float(), fold_id=np.arange(n) % int(traffic["folds"]),
                n_options=n_options, option_ids=option_ids)


def train_batches(traffic: Mapping, n_steps: int, seed: int) -> np.ndarray:
    """[n_steps, k, B] row indices of a pool of ``pool_rows_per_fold`` rows a
    fold (row i in fold i mod k): fold f trains on fold (f+1) mod k's rows,
    in a fresh permutation each pass over them, so the rows of one step all
    differ, and so do those of the first passes' steps."""
    k, b = int(traffic["folds"]), int(traffic["rows_per_fold"])
    per = int(traffic["pool_rows_per_fold"])
    rng = np.random.default_rng(substream(seed, 5))
    out = np.zeros((n_steps, k, b), np.int64)
    for f in range(k):
        src = (f + 1) % k
        rows = src + k * np.arange(per)
        stream: List[int] = []
        while len(stream) < n_steps * b:
            stream.extend(rng.permutation(rows).tolist())
        out[:, f, :] = np.asarray(stream[: n_steps * b]).reshape(n_steps, b)
    return out


def sample(n_total: int, n_take: int, seed: int, tag: int = 6) -> np.ndarray:
    """``n_take`` distinct indices of ``n_total``, drawn from the seed."""
    rng = np.random.default_rng(substream(seed, tag))
    return np.sort(rng.choice(n_total, size=min(n_take, n_total), replace=False))


def clone_tree(tree):
    """A copy of a nested dict of tensors."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()
