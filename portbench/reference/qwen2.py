"""The plain reference of the Qwen2 decoder with LoRA adapters, in float32.

Written from the published architecture (Qwen2ForCausalLM): RMSNorm with a
weight, rotary position embeddings (split halves, theta from the
configuration), grouped-query causal attention with biases on q, k and v,
a SwiGLU MLP, a final RMSNorm and the (tied or untied) head. An adapter
adds ``alpha / r · (x·Aᵀ)·Bᵀ`` to its projection. Weights are taken as the
benchmark made them (the port's layout: linear weights [in, out] stacked on
a leading layer axis) and widened to float32 a layer at a time.

It imports nothing of the program. It runs a layer at a time and a block of
rows at a time so that Qwen2.5-7B fits beside the program's weights:
training keeps each layer's input, then runs the backward a layer at a time
from the top, computing that layer's forward again with autograd on. The
attention is computed in blocks of queries, exactly (every block's softmax
over all its keys), the G query heads of a KV head as the rows of one
product, with its backward written out (dV = Pᵀ·dO, dP = dO·Vᵀ, dS =
P∘(dP − rowsum(dO∘O)), dQ = dS·K, dK = dSᵀ·Q); the backward's layer
pass reuses the attention output and row statistics of the first pass.

``quant="fp8"`` is the control: every product's operands rounded to
float8 (e4m3 in the forward, the incoming gradient e5m2 in the backward,
one scale a tensor from its largest magnitude), the sums in float32; the
step that would tempt a later change. TF32 is off for the float32
products.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0), "e5m2": (torch.float8_e5m2, 57344.0)}
#: the float32 attention matrices a block of queries may take
ATTN_BYTES = 1 << 30
_PROJ_KEYS = {"q": ("wq", "bq"), "k": ("wk", "bk"), "v": ("wv", "bv"), "o": ("wo", None),
              "gate": ("w_gate", None), "up": ("w_up", None), "down": ("w_down", None)}


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """x rounded to float8 ``fmt`` under one scale (its largest magnitude at
    the format's largest value), back in float32."""
    dtype, top = _FP8[fmt]
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(torch.float32) * scale


class _Fp8MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to e4m3, and the gradient to e5m2."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = round_fp8(a, "e4m3"), round_fp8(b, "e4m3")
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = round_fp8(g, "e5m2")
        ga = qg @ qb.mT if ctx.needs_input_grad[0] else None
        gb = None
        if ctx.needs_input_grad[1]:
            gb = qa.mT @ qg
            while gb.ndim > qb.ndim:
                gb = gb.sum(0)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """a [..., m, k] @ b [k, n] or batched alike, in float32 or the control's
    float8 operands."""
    if quant is None:
        return a @ b
    if b.ndim == 2 and a.ndim > 2:
        return _Fp8MatMul.apply(a.reshape(-1, a.shape[-1]), b).reshape(*a.shape[:-1], -1)
    return _Fp8MatMul.apply(a, b)


def _q(x: torch.Tensor, quant: Optional[str], fmt: str = "e4m3") -> torch.Tensor:
    return x if quant is None else round_fp8(x, fmt)


def _grouped(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q [b, S, H, dh] → [b, KVH, G, S, dh]: the G query heads that share a
    KV head (head h reads KV head h // G)."""
    b, s, h, dh = q.shape
    return q.transpose(1, 2).reshape(b, kvh, h // kvh, s, dh)


def _diagonal_mask(logits: torch.Tensor, s0: int, s1: int) -> torch.Tensor:
    """Mask, in place, the keys after each query of the block [s0, s1) in
    logits [b, KVH, G, s1 - s0, s1]: only the block's own keys can lie
    after a query."""
    n = s1 - s0
    future = torch.ones(n, n, dtype=torch.bool, device=logits.device).triu(1)
    logits[..., s0:s1].masked_fill_(future, float("-inf"))
    return logits


def attention_forward(q, k, v, block: int, quant: Optional[str]):
    """Causal grouped-query attention, q [b, S, H, dh], k and v [b, S, KVH,
    dh] in float32 → (o [b, KVH, G, S, dh], lse [b, KVH, G, S]), a block of
    queries at a time over the keys up to the block's end, each row's softmax
    whole."""
    b, s, h, dh = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = _q(_grouped(q, kvh) * (1.0 / math.sqrt(dh)), quant)
    kt, vt = _q(k.transpose(1, 2), quant), _q(v.transpose(1, 2), quant)
    o = torch.empty(b, kvh, g, s, dh, dtype=torch.float32, device=q.device)
    lse = torch.empty(b, kvh, g, s, dtype=torch.float32, device=q.device)
    for s0 in range(0, s, block):
        s1 = min(s, s0 + block)
        n = s1 - s0
        logits = (qg[:, :, :, s0:s1].reshape(b, kvh, g * n, dh) @ kt[:, :, :s1].mT)
        logits = _diagonal_mask(logits.view(b, kvh, g, n, s1), s0, s1)
        lse[..., s0:s1] = torch.logsumexp(logits, dim=-1)
        p = _q(torch.softmax(logits, dim=-1), quant).view(b, kvh, g * n, s1)
        o[:, :, :, s0:s1] = (p @ vt[:, :, :s1]).view(b, kvh, g, n, dh)
    return o, lse


def _heads_last(x: torch.Tensor) -> torch.Tensor:
    """[b, KVH, G, S, dh] → [b, S, H, dh]."""
    b, kvh, g, s, dh = x.shape
    return x.reshape(b, kvh * g, s, dh).transpose(1, 2)


class CausalAttention(torch.autograd.Function):
    """:func:`attention_forward` with its backward written out; ``saved``
    (o, lse) of the same q, k and v skips the forward's products."""

    @staticmethod
    def forward(ctx, q, k, v, block: int, quant: Optional[str], saved=None):
        o, lse = saved if saved is not None else attention_forward(q, k, v, block, quant)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.block, ctx.quant = block, quant
        return _heads_last(o)

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        block, quant = ctx.block, ctx.quant
        b, s, h, dh = q.shape
        kvh = k.shape[2]
        g = h // kvh
        scale = 1.0 / math.sqrt(dh)
        qg = _q(_grouped(q, kvh) * scale, quant)
        kt, vt = _q(k.transpose(1, 2), quant), _q(v.transpose(1, 2), quant)
        dog = _grouped(do, kvh)
        di = (dog * o).sum(-1)  # [b, KVH, G, S]
        dog = _q(dog, quant, "e5m2")
        dq = torch.empty_like(qg)
        dk = torch.zeros_like(kt)
        dv = torch.zeros_like(vt)
        for s0 in range(0, s, block):
            s1 = min(s, s0 + block)
            n = s1 - s0
            qb = qg[:, :, :, s0:s1].reshape(b, kvh, g * n, dh)
            dob = dog[:, :, :, s0:s1].reshape(b, kvh, g * n, dh)
            logits = _diagonal_mask((qb @ kt[:, :, :s1].mT).view(b, kvh, g, n, s1), s0, s1)
            p = logits.sub_(lse[..., s0:s1, None]).exp_()
            dv[:, :, :s1] += _q(p, quant).view(b, kvh, g * n, s1).mT @ dob
            dp = (dob @ vt[:, :, :s1].mT).view(b, kvh, g, n, s1)
            ds = _q(dp.sub_(di[..., s0:s1, None]).mul_(p), quant, "e5m2").view(b, kvh, g * n, s1)
            dq[:, :, :, s0:s1] = (ds @ kt[:, :, :s1]).view(b, kvh, g, n, dh)
            dk[:, :, :s1] += ds.mT @ qb
        return (_heads_last(dq * scale), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None)


def rope_tables(s: int, dh: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin [S, dh/2] of the split-half rotary embedding, worked out
    in float64, then float32."""
    inv = 1.0 / theta ** (np.arange(0, dh, 2, dtype=np.float64) / dh)
    ang = np.outer(np.arange(s, dtype=np.float64), inv)
    return (torch.from_numpy(np.cos(ang).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(ang).astype(np.float32)).to(device))


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


class Qwen2Reference:
    """The reference over one configuration's weights. ``adapter`` arguments
    are one fold's adapter {proj: {"a": [L, r, in], "b": [L, out, r]}} in
    float32 (or None)."""

    def __init__(self, cfg: Mapping, weights: Mapping, lora: Mapping,
                 quant: Optional[str] = None):
        no_tf32()
        self.cfg, self.weights, self.quant = cfg, weights, quant
        self.d = int(cfg["hidden_size"])
        self.h = int(cfg["num_attention_heads"])
        self.kvh = int(cfg["num_key_value_heads"])
        self.dh = int(cfg.get("head_dim") or self.d // self.h)
        self.n_layers = int(cfg["num_hidden_layers"])
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.tied = bool(cfg.get("tie_word_embeddings", False))
        self.lora_scale = float(lora["alpha"]) / float(lora["rank"])

    # -- pieces -----------------------------------------------------------------

    def layer_weights(self, i: int) -> Dict[str, torch.Tensor]:
        return {k: w[i].float() for k, w in self.weights["layers"].items()}

    def head(self) -> torch.Tensor:
        """[d, V] float32."""
        return (self.weights["embed"].float().T if self.tied
                else self.weights["lm_head"].float())

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.weights["embed"][tokens.long()].float()

    def _proj(self, name: str, x: torch.Tensor, lw, ad) -> torch.Tensor:
        wkey, bkey = _PROJ_KEYS[name]
        y = matmul(x, lw[wkey], self.quant)
        if ad is not None and name in ad:
            z = matmul(x, ad[name]["a"].mT, self.quant)
            y = y + self.lora_scale * matmul(z, ad[name]["b"].mT, self.quant)
        if bkey is not None and bkey in lw:
            y = y + lw[bkey]
        return y

    def _block(self, b: int, s: int) -> int:
        per_query = b * self.h * s * 4 * 2  # logits and dp in float32
        return max(64, min(s, (ATTN_BYTES // per_query) // 64 * 64))

    def layer(self, x: torch.Tensor, lw, ad, cos, sin, attn=None) -> torch.Tensor:
        """One decoder layer on x [b, S, d] float32. ``attn``: a list, to
        which the attention's (o, lse) is appended (no autograd), or the
        (o, lse) of the same layer's earlier pass, which the attention then
        reuses."""
        b, s, _ = x.shape
        h = rms_norm(x, lw["attn_norm"], self.eps)
        q = rotate(self._proj("q", h, lw, ad).reshape(b, s, self.h, self.dh), cos, sin)
        k = rotate(self._proj("k", h, lw, ad).reshape(b, s, self.kvh, self.dh), cos, sin)
        v = self._proj("v", h, lw, ad).reshape(b, s, self.kvh, self.dh)
        if isinstance(attn, list):
            attn.append(attention_forward(q, k, v, self._block(b, s), self.quant))
            a = _heads_last(attn[-1][0])
        else:
            a = CausalAttention.apply(q, k, v, self._block(b, s), self.quant, attn)
        x = x + self._proj("o", a.reshape(b, s, -1), lw, ad)
        h = rms_norm(x, lw["mlp_norm"], self.eps)
        act = F.silu(self._proj("gate", h, lw, ad)) * self._proj("up", h, lw, ad)
        return x + self._proj("down", act, lw, ad)

    def _layer_adapter(self, adapter, i: int, grad: bool):
        if adapter is None:
            return None
        return {p: {n: t[i].detach().clone().requires_grad_(grad) for n, t in ab.items()}
                for p, ab in adapter.items()}

    def hidden_inputs(self, tokens: torch.Tensor, adapter, attn: Optional[list] = None
                      ) -> Tuple[List[torch.Tensor], torch.Tensor]:
        """Each layer's input and the last layer's output, without autograd
        (``attn``: a list that receives each layer's attention (o, lse))."""
        s = tokens.shape[1]
        cos, sin = rope_tables(s, self.dh, self.theta, tokens.device)
        x = self.embed(tokens)
        xs = []
        with torch.no_grad():
            for i in range(self.n_layers):
                xs.append(x)
                store = [] if attn is None else attn
                x = self.layer(x, self.layer_weights(i), self._layer_adapter(adapter, i, False),
                               cos, sin, store)
        return xs, x

    # -- scoring ------------------------------------------------------------------

    @torch.no_grad()
    def letter_probs(self, tokens: torch.Tensor, answer_pos: torch.Tensor, option_ids,
                     n_options: Sequence[int], adapter) -> torch.Tensor:
        """Per-row probabilities [b, C] of the option letters at each row's
        answer position: a softmax over the row's first ``n_options``
        letters, 0 beyond."""
        _, x = self.hidden_inputs(tokens, adapter)
        h = rms_norm(x[torch.arange(x.shape[0], device=x.device), answer_pos.long()],
                     self.weights["final_norm"].float(), self.eps)
        cols = torch.as_tensor(np.asarray(option_ids), device=h.device).long()
        logits = matmul(h, self.head()[:, cols], self.quant)
        n = torch.as_tensor(np.asarray(n_options), device=h.device)[:, None]
        logits = logits.masked_fill(torch.arange(logits.shape[1], device=h.device)[None] >= n,
                                    float("-inf"))
        return torch.softmax(logits, dim=-1)

    # -- training -----------------------------------------------------------------

    def window_loss(self, x_last: torch.Tensor, tokens: torch.Tensor, mask: torch.Tensor,
                    answer_pos: torch.Tensor, t_max: int, denom: torch.Tensor) -> torch.Tensor:
        """Σ over the rows' answer windows of −log p(next token)·mask, over
        ``denom``: positions answer_pos + j, j < t_max, that lie before the
        row's last token predict the token after them."""
        b, s, _ = x_last.shape
        rows = answer_pos.long()[:, None] + torch.arange(t_max, device=tokens.device)[None]
        inside = rows <= s - 2
        rows = rows.clamp_max(s - 2)
        h = rms_norm(x_last, self.weights["final_norm"].float(), self.eps)
        hsel = h.gather(1, rows[..., None].expand(-1, -1, h.shape[-1]))
        logp = torch.log_softmax(matmul(hsel, self.head(), self.quant), dim=-1)
        labels = tokens.long().gather(1, rows + 1)
        wts = mask.gather(1, rows + 1) * inside
        nll = -logp.gather(-1, labels[..., None])[..., 0]
        return (nll * wts).sum() / denom

    def loss_and_grads(self, tokens: torch.Tensor, mask: torch.Tensor,
                       answer_pos: torch.Tensor, t_max: int, adapter,
                       row_block: int) -> Tuple[float, Dict]:
        """One fold's window loss (the mean over its target tokens) and the
        gradient of every adapter leaf, in blocks of ``row_block`` rows."""
        s = tokens.shape[1]
        cos, sin = rope_tables(s, self.dh, self.theta, tokens.device)
        rows = answer_pos.long()[:, None] + torch.arange(t_max, device=tokens.device)[None]
        wts = mask.gather(1, (rows.clamp_max(s - 2) + 1)) * (rows <= s - 2)
        denom = wts.sum().clamp_min(1.0)
        grads = {p: {n: torch.zeros_like(t) for n, t in ab.items()} for p, ab in adapter.items()}
        loss = 0.0
        for r0 in range(0, tokens.shape[0], row_block):
            sl = slice(r0, r0 + row_block)
            attn: list = []
            xs, x_last = self.hidden_inputs(tokens[sl], adapter, attn)
            x_last = x_last.detach().requires_grad_(True)
            part = self.window_loss(x_last, tokens[sl], mask[sl], answer_pos[sl], t_max, denom)
            part.backward()
            loss += float(part.detach())
            g = x_last.grad
            for i in reversed(range(self.n_layers)):
                x_in = xs[i].detach().requires_grad_(i > 0)
                ad = self._layer_adapter(adapter, i, True)
                with torch.enable_grad():
                    out = self.layer(x_in, self.layer_weights(i), ad, cos, sin, attn[i])
                torch.autograd.backward(out, g)
                for p, ab in ad.items():
                    for n, t in ab.items():
                        grads[p][n][i] += t.grad
                g = x_in.grad
                xs[i] = attn[i] = None
        return loss, grads


def warmup_cosine(count: int, optim: Mapping) -> float:
    """The learning rate of update ``count`` (0 at the first): linear warmup
    from 0 over max(int(total·frac), 1) updates, then a cosine from the peak
    to ``end_value_frac`` of it."""
    lr, total = float(optim["lr"]), int(optim["total_steps"])
    warm = max(int(total * float(optim["warmup_frac"])), 1)
    if count < warm:
        return lr * count / warm
    decay = max(total, warm + 1) - warm
    t = min(count - warm, decay)
    end = float(optim.get("end_value_frac", 0.0))
    return lr * ((1 - end) * 0.5 * (1 + math.cos(math.pi * t / decay)) + end)


def adamw(params, grads, state, count: int, optim: Mapping):
    """One AdamW update in float32 → (params, state): moments, bias
    correction, the update over sqrt(v̂) + eps, decoupled weight decay, the
    learning rate of ``count``."""
    b1, b2 = float(optim["b1"]), float(optim["b2"])
    wd, eps = float(optim.get("weight_decay", 0.0)), float(optim.get("eps", 1e-8))
    lr = warmup_cosine(count, optim)
    mu = {p: {n: (1 - b1) * grads[p][n] + b1 * state["mu"][p][n] for n in ab}
          for p, ab in params.items()}
    nu = {p: {n: (1 - b2) * grads[p][n] ** 2 + b2 * state["nu"][p][n] for n in ab}
          for p, ab in params.items()}
    c = count + 1
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    new = {}
    for p, ab in params.items():
        new[p] = {}
        for n, t in ab.items():
            u = (mu[p][n] / bc1) / (torch.sqrt(nu[p][n] / bc2) + eps) + wd * t
            new[p][n] = t - lr * u
    return new, {"mu": mu, "nu": nu}


def train_steps(ref: Qwen2Reference, batches: Sequence[Tuple], t_max: int, adapters: Sequence,
                optim: Mapping, row_block: int,
                loss_fn: Optional[Callable] = None) -> Dict[str, object]:
    """The reference's first steps of every fold: ``batches[t][f]`` = (tokens,
    mask, answer_pos) of fold f at step t; ``adapters[f]`` fold f's starting
    adapter (float32). → {"losses": [steps][k], "grad1": [k] trees (the first
    step's gradients), "delta": [k] trees (the adapters' change after the
    steps)}. ``loss_fn`` replaces :meth:`Qwen2Reference.loss_and_grads` (a
    fault planted in the reference's place)."""
    loss_fn = loss_fn or ref.loss_and_grads
    k = len(adapters)
    params = [{p: {n: t.clone() for n, t in ab.items()} for p, ab in a.items()} for a in adapters]
    states = [{"mu": {p: {n: torch.zeros_like(t) for n, t in ab.items()} for p, ab in a.items()},
               "nu": {p: {n: torch.zeros_like(t) for n, t in ab.items()} for p, ab in a.items()}}
              for a in adapters]
    losses, grad1 = [], None
    for t, batch in enumerate(batches):
        row, grads_t = [], []
        for f in range(k):
            tokens, mask, pos = batch[f]
            loss, grads = loss_fn(tokens, mask, pos, t_max, params[f], row_block)
            row.append(loss)
            grads_t.append(grads)
            params[f], states[f] = adamw(params[f], grads, states[f], t, optim)
        losses.append(row)
        if t == 0:
            grad1 = grads_t
    delta = [{p: {n: params[f][p][n] - adapters[f][p][n] for n in ab} for p, ab in a.items()}
             for f, a in enumerate(adapters)]
    return {"losses": losses, "grad1": grad1, "delta": delta}
