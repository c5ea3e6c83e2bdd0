"""Fused SwiGLU MLP, ``down(silu(x·Wg)·(x·Wu))``: a hand-written CUDA forward
for Hopper (two wgmma kernels) inside a ``torch.autograd.Function``.

Counterpart of ``tst/kernels/fused_mlp.py``: ``fused_swiglu_mlp`` (:116), its
custom_vjp (:84), the Pallas kernel ``_fused_mlp_kernel`` (:44) and
``swiglu_reference`` (:136). The CUDA source is ``tst_torch/csrc/fused_mlp.cu``;
its header says what bounds it on the card and how the design answers.

For CUDA tensors the forward launches the two kernels, gate-up (h =
silu(x·Wg)·(x·Wu), bf16, in a scratch tensor that lives for the call) and
down (h·Wd), or raises: there is no fallback; for CPU tensors it takes the
plain version, :func:`swiglu_reference`. The backward is the reference's ``_swiglu_bwd``
(:93-110) on every device: the hidden is recomputed in f32 and every product
is a plain f32 ``torch.matmul``, as in the reference; weight gradients are
computed only for the inputs that need them (``ctx.needs_input_grad``: the
frozen base needs none), with the same numbers where they are.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tst_torch.kernels import _build

#: calls of the kernel pair (one per MLP forward) made in this process
LAUNCHES = 0

#: the kernels' constraints: D a multiple of 128, F of 64
D_MULTIPLE, F_MULTIPLE = 128, 64


def swiglu_reference(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor) -> torch.Tensor:
    """Plain version (the decoder's MLP math): gate and up products in f32,
    h = silu(g)·u rounded to x's dtype, the down product accumulated in f32
    and rounded to x's dtype."""
    g = x.float() @ w_gate.float()
    u = x.float() @ w_up.float()
    h = (F.silu(g) * u).to(x.dtype)
    return (h.float() @ w_down.float()).to(x.dtype)


def check_kernel_args(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor) -> None:
    """Raise ValueError on anything the CUDA kernel does not take."""
    if x.ndim != 2 or w_gate.ndim != 2:
        raise ValueError(f"want x [M, D] and weights [D, F]; got {tuple(x.shape)}, "
                         f"{tuple(w_gate.shape)}")
    m, d = x.shape
    f = w_gate.shape[1]
    if w_gate.shape != (d, f) or w_up.shape != (d, f) or w_down.shape != (f, d):
        raise ValueError(f"weights {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)} do not match x {tuple(x.shape)}")
    if m == 0 or d % D_MULTIPLE or f % F_MULTIPLE:
        raise ValueError(f"the kernel takes M >= 1, D a multiple of {D_MULTIPLE} and F of "
                         f"{F_MULTIPLE}; got M={m}, D={d}, F={f}")
    for name, t in (("x", x), ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} is {t.dtype}; the kernel takes torch.bfloat16")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The library's C entry ``name``, typed once: pointers, then M and the
    two widths, the device, the stream."""
    fn = getattr(_build.library(), name)
    fn.restype = ctypes.c_int
    n_ptr = 4 if name == "tst_swiglu_gate_up" else 3
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return fn


def _call(name: str, ptrs, m: int, k: int, n: int, device: torch.device) -> None:
    err = _entry(name)(*ptrs, m, k, n, device.index, _build.current_stream(device))
    if err != 0:
        raise RuntimeError(f"{name} failed with cudaError_t {err} (M={m}, K={k}, N={n})")


def _gate_up(x, w_gate, w_up) -> torch.Tensor:
    """The gate-up kernel on checked CUDA tensors → h [M, F] bf16."""
    m, d = x.shape
    f = w_gate.shape[1]
    h = torch.empty((m, f), dtype=x.dtype, device=x.device)
    _call("tst_swiglu_gate_up", (x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), h.data_ptr()),
          m, d, f, x.device)
    return h


def _down(h, w_down) -> torch.Tensor:
    """The down kernel on checked CUDA tensors → out [M, D] bf16."""
    m, f = h.shape
    d = w_down.shape[1]
    out = torch.empty((m, d), dtype=h.dtype, device=h.device)
    _call("tst_swiglu_down", (h.data_ptr(), w_down.data_ptr(), out.data_ptr()), m, f, d, h.device)
    return out


def _launch(x, w_gate, w_up, w_down) -> torch.Tensor:
    """The kernel pair on checked CUDA tensors → out [M, D] bf16."""
    global LAUNCHES
    out = _down(_gate_up(x, w_gate, w_up), w_down)
    LAUNCHES += 1
    return out


def fused_mlp_forward(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor) -> torch.Tensor:
    """The forward on x [M, D]: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.device.type == "cpu":
        return swiglu_reference(x, w_gate, w_up, w_down)
    if x.device.type != "cuda":
        raise ValueError(f"fused_swiglu_mlp: unsupported device {x.device}")
    check_kernel_args(x, w_gate, w_up, w_down)
    return _launch(x, w_gate, w_up, w_down)


class _SwiGLU(torch.autograd.Function):
    """Forward saves (x, Wg, Wu, Wd); backward is ``_swiglu_bwd`` in f32."""

    @staticmethod
    def forward(ctx, x2d, w_gate, w_up, w_down):
        ctx.save_for_backward(x2d, w_gate, w_up, w_down)
        return fused_mlp_forward(x2d, w_gate, w_up, w_down)

    @staticmethod
    def backward(ctx, dout):
        x, wg, wu, wd = ctx.saved_tensors
        need_x, need_wg, need_wu, need_wd = ctx.needs_input_grad
        xf, wgf, wuf, wdf = x.float(), wg.float(), wu.float(), wd.float()
        g = xf @ wgf
        u = xf @ wuf
        sg = torch.sigmoid(g)
        silu_g = g * sg
        doutf = dout.float()
        dh = doutf @ wdf.T
        du = dh * silu_g
        dg = dh * u * (sg + g * sg * (1 - sg))  # d silu(g)/dg = sig + g·sig·(1-sig)
        dx = (dg @ wgf.T + du @ wuf.T).to(x.dtype) if need_x else None
        dwg = (xf.T @ dg).to(wg.dtype) if need_wg else None
        dwu = (xf.T @ du).to(wu.dtype) if need_wu else None
        dwd = ((silu_g * u).T @ doutf).to(wd.dtype) if need_wd else None
        return dx, dwg, dwu, dwd


def fused_swiglu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                     w_down: torch.Tensor, block_m: int = 0, block_f: int = 0) -> torch.Tensor:
    """SwiGLU MLP with the leading dims flattened into rows, differentiable in
    all four inputs. ``block_m``/``block_f`` are the TPU kernel's tile knobs
    and have no effect: the CUDA kernel picks its own tiles."""
    d = x.shape[-1]
    out = _SwiGLU.apply(x.reshape(-1, d).contiguous(), w_gate.contiguous(),
                        w_up.contiguous(), w_down.contiguous())
    return out.reshape(*x.shape[:-1], d)
