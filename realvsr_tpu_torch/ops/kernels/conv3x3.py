"""Kernel 2: NHWC 3x3 conv with a fused epilogue on Hopper (``csrc/conv3x3.cu``).

Replaces ``realvsr_tpu/ops/pallas/conv3x3_kernel.py::_packed_pallas`` (public
``conv3x3_packed``; its ``splits`` take PCD's concat inputs, here the
second input pointer ``x2`` does).  Bound on the H100: the 64->64 convs at
(3, 512, 1024) sit near the ridge (116 GFLOP, 0.4-0.6 GB); 128->64 is
compute-bound (232 GFLOP).  The kernel is an implicit GEMM on the tensor
cores (``mma.sync``) from an input halo held in shared memory, so the input
is read ~1.6x rather than 9x and the epilogue (bias, activation, cast,
residual) never leaves registers; see the source for the design.  No pair
packing: the TPU's 128-lane layout is not carried over.

:func:`conv3x3` launches the kernel for a CUDA tensor and counts the launch
in ``conv3x3.launches``; for a CPU tensor it runs :func:`conv3x3_plain`.
:func:`conv3x3_autograd` is the differentiable op: the kernel forward, and a
backward through cuDNN's data and weight gradients in the activation dtype,
as the JAX package's custom VJP (``conv3x3_kernel.py::_packed_core_bwd``)
leaves its backward to stock XLA.  Unlike that VJP it does not recompute the
forward: the activation's slope comes from the kernel's own output (as the
DCN's backward does), so the gradient follows the forward's decisions — a
bf16 recompute rounds the conv before the bias and flips the sign of some
pre-activations near 0.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from realvsr_tpu_torch.ops.deform_conv import act_grad, apply_act
from realvsr_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_FUNCS = tuple(
    (f"conv3x3_{s}", (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P))
    for s in _build.SUFFIX.values())
_HALO, _COUT, _SMEM_MAX = (4 + 2) * (32 + 2), 64, 232448


def conv3x3_plain(x, weight, bias=None, act=None, residual=None, x2=None):
    """The kernel's function in plain PyTorch: conv in f32, + bias, act,
    cast to the input type, + residual (in the input type)."""
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    y = F.conv2d(xin.permute(0, 3, 1, 2).float(), weight.float(),
                 None if bias is None else bias.float(), padding=1)
    y = apply_act(y, act).permute(0, 2, 3, 1).to(x.dtype)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None, act: str | None = None,
            residual: torch.Tensor | None = None,
            x2: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 / stride 1 / SAME conv of NHWC ``x`` (channel-concatenated with
    ``x2`` when given), + bias, act None / "relu" / "lrelu", cast, +
    ``residual`` (added after the activation).

    x: (B, H, W, c1); x2: (B, H, W, c2) or None; weight (64, c1 + c2, 3, 3);
    bias (64,) or None; residual (B, H, W, 64) or None.  All contiguous, of
    one dtype, bf16 or f32 (f32 runs the tensor cores in TF32); c1 and c2
    multiples of 16.
    """
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, act, residual, x2)
    if not x.is_cuda:
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    if x.dtype not in _build.SUFFIX:
        raise ValueError(f"conv3x3: dtype {x.dtype} not supported")
    if act not in _build.ACTS:
        raise ValueError(f"conv3x3: unknown activation {act!r}")
    if x.dim() != 4:
        raise ValueError("conv3x3: x must be (B, H, W, C)")
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    if c1 % 16 or c2 % 16:
        raise ValueError(f"conv3x3: input channels {c1}+{c2} must be "
                         "multiples of 16")
    pad = 16 // x.element_size()
    if (_HALO + _COUT) * (c1 + c2 + pad) * x.element_size() > _SMEM_MAX:
        raise ValueError(f"conv3x3: {c1 + c2} input channels exceed shared "
                         "memory")
    dt, dev = x.dtype, x.device
    _build.check_tensor(x, "x", (b, h, w, c1), dt, dev)
    if x2 is not None:
        _build.check_tensor(x2, "x2", (b, h, w, c2), dt, dev)
    if weight.shape[0] != _COUT:
        raise ValueError(f"conv3x3: the kernel writes {_COUT} output "
                         f"channels, weight has {weight.shape[0]}")
    _build.check_tensor(weight, "weight", (_COUT, c1 + c2, 3, 3), dt, dev)
    if bias is not None:
        _build.check_tensor(bias, "bias", (_COUT,), dt, dev)
    if residual is not None:
        _build.check_tensor(residual, "residual", (b, h, w, _COUT), dt, dev)
    wk = weight.permute(0, 2, 3, 1).contiguous()  # (cout, tap, cin)
    out = torch.empty(b, h, w, _COUT, device=dev, dtype=dt)
    lib = _build.load("conv3x3", _FUNCS)
    with torch.cuda.device(dev):
        code = getattr(lib, f"conv3x3_{_build.SUFFIX[dt]}")(
            x.data_ptr(), c1, None if x2 is None else x2.data_ptr(), c2,
            wk.data_ptr(), None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, h, w, _build.ACTS[act],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "conv3x3")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0



def _grad_conv(x, weight, g_nchw):
    """(d input, d weight) of a 3x3 / s1 / p1 conv of NHWC ``x`` for the
    NCHW cotangent ``g_nchw``, in the input dtype (cuDNN on the card)."""
    xn = x.permute(0, 3, 1, 2)
    dx = torch.nn.grad.conv2d_input(xn.shape, weight, g_nchw, padding=1)
    dw = torch.nn.grad.conv2d_weight(xn, weight.shape, g_nchw, padding=1)
    return dx.permute(0, 2, 3, 1), dw


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, x2, act):
        out = conv3x3(x, weight, bias, act, residual, x2)
        ctx.save_for_backward(x, weight, x2, None if act is None else out)
        ctx.act = act
        ctx.has_bias = bias is not None
        ctx.has_residual = residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, x2, out = ctx.saved_tensors
        g_pre = act_grad(g, out, ctx.act)
        gn = g_pre.permute(0, 3, 1, 2)
        c1 = x.shape[-1]
        dx, dweight = _grad_conv(x, weight[:, :c1], gn)
        dx2 = None
        if x2 is not None:
            dx2, dw2 = _grad_conv(x2, weight[:, c1:], gn)
            dweight = torch.cat([dweight, dw2], dim=1)
        dbias = (g_pre.float().sum((0, 1, 2)).to(g.dtype) if ctx.has_bias
                 else None)
        return (dx, dweight, dbias, g if ctx.has_residual else None, dx2,
                None)


def conv3x3_autograd(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, act: str | None = None,
                     residual: torch.Tensor | None = None,
                     x2: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable :func:`conv3x3` (the kernel for a CUDA tensor, its
    plain version for a CPU tensor), with a backward through the conv's data
    and weight gradients (cuDNN on the card).  The backward takes the
    activation's slope from the forward's output, so an activation and a
    residual (added after it) do not go together here."""
    if act is not None and residual is not None:
        raise ValueError("conv3x3_autograd: an activation with a residual "
                         "is not differentiable here")
    return _Conv3x3.apply(x, weight, bias, residual, x2, act)
