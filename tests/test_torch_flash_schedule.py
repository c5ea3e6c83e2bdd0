"""The shapes K1 (tst_torch.kernels.flash_attention) takes since its forward
and dK/dV kernels walk 128-row tiles, and the bounds its card rows rest on.

The kernels read 128-row tiles of Q, K and V through 3-D TMA maps that end at
each batch row's S, so any S that is a multiple of 64 stays valid, S = 576
(9 x 64, not a multiple of 128) among them; S = 100 is still refused by both
wrappers' checks. ``chip_smoke._attention_bounds`` is pinned at the long
preset's call and at Llama-3-8B's train step (meta tensors: shapes only)."""

import sys
from pathlib import Path

import pytest
import torch

import tst_torch.kernels.flash_attention as tfa

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


def _args(s, h=4, kvh=2, d=64):
    q = torch.zeros(2, s, h, d, dtype=torch.bfloat16)
    kv = torch.zeros(2, s, kvh, d, dtype=torch.bfloat16)
    return q, kv


@pytest.mark.parametrize("s,d", [(576, 64), (576, 128), (64, 64), (1088, 128)])
def test_forward_and_backward_checks_take_any_multiple_of_64(s, d):
    q, kv = _args(s, d=d)
    tfa.check_kernel_args(q, kv, kv, causal=True)
    tfa.check_backward_args(q, kv, kv, torch.zeros(2, 4, s), torch.zeros(2, 4, s), q)


@pytest.mark.parametrize("s", [100, 96, 600])
def test_forward_and_backward_checks_refuse_other_lengths(s):
    q, kv = _args(s)
    with pytest.raises(ValueError, match="multiple of 64"):
        tfa.check_kernel_args(q, kv, kv, causal=True)
    with pytest.raises(ValueError, match="multiple of 64"):
        tfa.check_backward_args(q, kv, kv, torch.zeros(2, 4, s), torch.zeros(2, 4, s), q)


@pytest.mark.parametrize("shape,want", [
    ((10, 16384, 14, 2, 64), {"fwd": (4.864, "operations"), "dkv": (9.73, "operations"),
                              "dq": (7.30, "operations")}),
    ((40, 512, 32, 8, 128), {"fwd": (0.126, "bytes")}),
])
def test_attention_bounds_at_the_long_and_8b_calls(shape, want):
    b, s, h, kvh, d = shape
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(b, s, kvh, d, dtype=torch.bfloat16, device="meta")
    bounds = chip_smoke._attention_bounds(q, k)
    for key, (ms, by) in want.items():
        assert bounds[key]["bound_ms"] == pytest.approx(ms, rel=1e-2)
        assert bounds[key]["bound_by"] == by


def test_k1_summary_ratios():
    rows = chip_smoke.k1_summary({"fwd": {"ms": 2.0, "library_ms": 4.0, "bound_ms": 1.0}})
    assert rows == {"fwd": {"ratio_to_library": 0.5, "share_of_bound": 0.5}}
    assert chip_smoke.k1_summary({"dkv": {"ms": 2.0, "library_ms": None, "bound_ms": 1.0}}) == {
        "dkv": {"ratio_to_library": None, "share_of_bound": 0.5}}


def test_k1_summary_keeps_each_rows_clock_reading():
    """A dQ row timed with the card's SM clock and power draw beside it
    keeps that reading in the summary; a row without one gets none."""
    rows = chip_smoke.k1_summary({
        "dkv": {"ms": 2.0, "library_ms": 4.0, "bound_ms": 1.0},
        "dq": {"ms": 1.0, "library_ms": 4.0, "bound_ms": 0.5,
               "clocks_sm_power": "1980 MHz, 612.40 W"}})
    assert rows == {"dkv": {"ratio_to_library": 0.5, "share_of_bound": 0.5},
                    "dq": {"ratio_to_library": 0.25, "share_of_bound": 0.5,
                           "clocks_sm_power": "1980 MHz, 612.40 W"}}
