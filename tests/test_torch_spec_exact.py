"""The invariances that make the port's speculative decode equal to its greedy
decode bit for bit (tst_torch.models.decode, spec_decode, the K3 split plan
and the decode-attention kernel's plain version).

A row's logits in a verify chunk (T = gamma + 1) must be the bits of the
greedy steps (T = 1) that reach the same positions, whatever the cache's
length and wherever rejected slots sit: f32 on the CPU, on the plain path,
port only (weights from a torch seed).
"""

import inspect

import numpy as np
import pytest
import torch

from tst_torch.kernels import decode_attention as tda
from tst_torch.kernels import quant_matmul as tqm
from tst_torch.models import decode as tdecode
from tst_torch.models import quant as tquant
from tst_torch.models import spec_decode as tspec
from tst_torch.models.decoder import init_params
from tst_torch.models.lora import LoraSpec, init_lora
from tst_torch.models.spec import spec_by_name

SPEC = spec_by_name("tiny", dtype=torch.float32)
B, S, GAMMA = 5, 40, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed=0, folds=None, quantize=None):
    g = torch.Generator().manual_seed(seed)
    params = init_params(g, SPEC)
    if quantize:
        params = tquant.quantize_params(params, quantize)
    lspec = LoraSpec(rank=4, dtype=torch.float32)
    loras = [init_lora(g, SPEC, lspec) for _ in range(folds or 1)]
    for lora in loras:
        for ab in lora.values():
            ab["b"] = 0.1 * torch.randn(ab["b"].shape, generator=g)
    if folds:
        lora = {name: {leaf: torch.stack([lo[name][leaf] for lo in loras])
                       for leaf in ("a", "b")} for name in loras[0]}
    else:
        lora = loras[0]
    tokens = torch.randint(0, 250, (B * (folds or 1), S), generator=g)
    plen = torch.randint(8, S, (B * (folds or 1),), generator=g)
    return params, lora, lspec, tokens, plen


def test_split_plan_takes_no_m():
    assert list(inspect.signature(tqm.split_plan.__wrapped__).parameters) == ["k", "n_half"]


@pytest.mark.parametrize("folds,quantize", [(None, None), (2, None), (None, "int4"),
                                            (None, "int8")])
def test_chunk_row_equals_its_steps_bit_for_bit(folds, quantize):
    """Three greedy steps (T=1) against one chunk (T=3) over the same tokens,
    the chunk in a cache 128 slots longer, after two rejected slots holding
    other keys and values: every logit equal."""
    params, lora, lspec, tokens, plen = _model(folds=folds, quantize=quantize)
    rows = tokens.shape[0]
    with torch.inference_mode():
        tok0, kc, vc, head, rope = tdecode.prefill(params, tokens, plen, 8, SPEC, lora=lora,
                                                   lora_spec=lspec)
        ar = torch.arange(kc.shape[2])[None]
        kg, vg, cur, fed, steps = kc.clone(), vc.clone(), tok0, [], []
        for t in range(GAMMA + 1):
            valid = (ar < plen[:, None]) | ((ar >= S) & (ar < S + t))
            lg, kg, vg = tdecode.chunk_logits(params, lora, lspec, SPEC, cur[:, None],
                                              (plen + t)[:, None], S + t, valid, kg, vg,
                                              head=head, rope=rope)
            fed.append(cur)
            steps.append(lg[:, 0])
            cur = lg[:, 0].argmax(-1)
        longer = kc.shape[2] + 128
        k2 = torch.zeros((kc.shape[0], rows, longer) + tuple(kc.shape[3:]))
        v2 = torch.zeros_like(k2)
        k2[:, :, :S], v2[:, :, :S] = kc[:, :, :S], vc[:, :, :S]
        k2[:, :, S: S + 2], v2[:, :, S: S + 2] = 7.0, -3.0  # a rejected round's slots
        valid = torch.arange(longer)[None] < plen[:, None]
        chunk, _, _ = tdecode.chunk_logits(
            params, lora, lspec, SPEC, torch.stack(fed, 1),
            plen[:, None] + torch.arange(GAMMA + 1)[None], S + 2, valid, k2, v2, head=head)
    for t in range(GAMMA + 1):
        assert torch.equal(chunk[:, t], steps[t]), t


@pytest.mark.parametrize("folds,quantize", [(None, None), (2, "int8")])
def test_chunk_runs_library_products_at_a_steps_shape(monkeypatch, folds, quantize):
    """A T=3 chunk runs every library product (the base projections, the
    LoRA deltas, the head) through _by_position, and each call of the base
    product and the delta takes contiguous [B, 1, ...] activations, a greedy
    step's shape: the library chooses its GEMM by M."""
    params, lora, lspec, tokens, plen = _model(folds=folds, quantize=quantize)
    rows, products, chunks = tokens.shape[0], [], []
    by_position, qdot, delta = tdecode._by_position, tdecode.qdot, tdecode.apply_lora_delta

    def chunked(fn, y):
        chunks.append(tuple(y.shape))
        return by_position(fn, y)

    def recorded(name, fn):
        def call(y, *args, **kwargs):
            products.append((name, tuple(y.shape[:2]), y.is_contiguous()))
            return fn(y, *args, **kwargs)
        return call

    with torch.inference_mode():
        tok0, kc, vc, head, rope = tdecode.prefill(params, tokens, plen, 8, SPEC, lora=lora,
                                                   lora_spec=lspec)
        monkeypatch.setattr(tdecode, "_by_position", chunked)
        monkeypatch.setattr(tdecode, "qdot", recorded("base", qdot))
        monkeypatch.setattr(tdecode, "apply_lora_delta",
                            lambda ab, y, spec: recorded("lora", lambda x: delta(ab, x, spec))(y))
        valid = torch.arange(kc.shape[2])[None] < plen[:, None]
        tdecode.chunk_logits(params, lora, lspec, SPEC, tokens[:, :GAMMA + 1],
                             plen[:, None] + torch.arange(GAMMA + 1)[None], S, valid, kc, vc,
                             head=head, rope=rope)
    per_layer = {"base": 7, "lora": len(lora)}
    assert len(chunks) == SPEC.n_layers * sum(per_layer.values()) + 1  # and the head
    assert all(shape[:2] == (rows, GAMMA + 1) for shape in chunks)
    for name, n in per_layer.items():
        calls = [(shape, contiguous) for kind, shape, contiguous in products if kind == name]
        assert len(calls) == SPEC.n_layers * n * (GAMMA + 1)
        assert all(shape == (rows, 1) and contiguous for shape, contiguous in calls)


def test_speculative_equals_greedy_with_adapter_and_unrelated_draft():
    params, lora, lspec, tokens, plen = _model()
    draft = init_params(torch.Generator().manual_seed(9), SPEC)
    with torch.inference_mode():
        want = tdecode.greedy_decode(params, tokens, plen, 12, SPEC, lora=lora, lora_spec=lspec)
    got, stats = tspec.speculative_greedy_decode(draft, SPEC, params, SPEC, tokens, plen, 12,
                                                 gamma=GAMMA, lora=lora, lora_spec=lspec,
                                                 return_stats=True)
    assert torch.equal(got, want)
    assert stats["rounds"] >= 11 // (GAMMA + 1)


def test_cache_attention_reference_is_the_softmax():
    """The plain version against a dense masked softmax in float64."""
    rng = np.random.default_rng(0)
    b, t, h, kvh, s, d = 2, 3, 4, 2, 20, 16
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32))
               for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    mask = torch.from_numpy(rng.random((b, t, s)) < 0.6)
    mask[..., 0] = True
    got = tda.cache_attention_reference(q, k, v, mask)
    kk = k.double().repeat_interleave(h // kvh, dim=2)
    vv = v.double().repeat_interleave(h // kvh, dim=2)
    sc = torch.einsum("bthd,bshd->bhts", q.double(), kk) / np.sqrt(d)
    sc = sc.masked_fill(~mask[:, None], -np.inf)
    want = torch.einsum("bhts,bshd->bthd", torch.softmax(sc, -1), vv)
    torch.testing.assert_close(got.double(), want, atol=1e-5, rtol=1e-5)
    assert torch.equal(tda.cache_attention(q, k, v, mask), got)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("slot_chunk", [1, 7, 64])
def test_cache_attention_reference_slot_chunks_change_no_bit(monkeypatch, slot_chunk, dtype):
    """The p·v sum carried across slot chunks is the one cumulative sum over
    every slot: the plain version's bits do not depend on its chunk."""
    rng = np.random.default_rng(1)
    b, t, h, kvh, s, d = 2, 3, 4, 2, 150, 16
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
               for shape in ((b, t, h, d), (b, s, kvh, d), (b, s, kvh, d)))
    mask = torch.from_numpy(rng.random((b, t, s)) < 0.5)
    mask[..., 0] = True
    monkeypatch.setattr(tda, "SLOT_CHUNK", s)
    want = tda.cache_attention_reference(q, k, v, mask)
    monkeypatch.setattr(tda, "SLOT_CHUNK", slot_chunk)
    assert torch.equal(tda.cache_attention_reference(q, k, v, mask), want)


def test_cache_attention_refuses_what_the_kernel_does_not_take():
    q = torch.zeros(1, 1, 4, 32, dtype=torch.bfloat16)
    k = torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        tda.check_kernel_args(q, k, k, torch.ones(1, 1, 8, dtype=torch.bool))
    q = torch.zeros(1, 1, 4, 64, dtype=torch.float32)
    k = torch.zeros(1, 8, 2, 64, dtype=torch.float32)
    with pytest.raises(ValueError, match="the kernel takes torch.bfloat16"):
        tda.check_kernel_args(q, k, k, torch.ones(1, 1, 8, dtype=torch.bool))
    with pytest.raises(ValueError, match="unsupported device"):
        tda.cache_attention(q.to("meta"), k.to("meta"), k.to("meta"),
                            torch.ones(1, 1, 8, dtype=torch.bool, device="meta"))
