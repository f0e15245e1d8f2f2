"""Kernels 1 and 2: DCNv2 forward and backward on Hopper
(``csrc/dcn_fwd.cu``, ``csrc/dcn_bwd.cu``).

The forward replaces ``realvsr_tpu/ops/pallas/dcn_frame_kernel.py::
dcn_frame_fused`` (input prep ``realvsr_tpu/ops/deform_conv_block.py::
_frame_prep``), the backward ``dcn_frame_kernel.py::dcn_frame_fused_bwd``
with its XLA epilogues ``_fold_dpg`` / ``_fold_dcoord``.  Both are bound on
the H100 by memory: the forward moves ~1.1 GB (x, offset, mask, out) for
116 GFLOP at the L1 shape (3, 512, 1024, 64); the backward ~1.25 KB per
pixel (x, offset, mask, g read; dx, doffset, dmask written) for 4 * 576 *
64 flop.  Both keep the sampled columns out of device memory (the backward
recomputes them) and run the tap products on the tensor cores
(``mma.sync``); see the sources for the designs.  Positions are exact f32:
the TPU kernels' int16 fixed-point positions and lane panels are not
carried over.

:func:`dcn_fwd` and :func:`dcn_bwd` launch their kernels for a CUDA tensor
and count the launch in ``.launches``; for a CPU tensor they run
:func:`dcn_fwd_plain` / :func:`dcn_bwd_plain`.  :func:`dcn_autograd` is
the differentiable op: forward :func:`dcn_fwd`, backward :func:`dcn_bwd`
after the fused activation and bias are undone here, as the JAX package
adds the bias outside its kernel and leaves its gradient to XLA.
"""
from __future__ import annotations

import ctypes

import torch

from realvsr_tpu_torch.ops.deform_conv import (act_grad,
                                               modulated_deform_conv_plain)
from realvsr_tpu_torch.ops.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_FUNCS = tuple(
    (f"dcn_fwd_{s}", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                      _P))
    for s in _build.SUFFIX.values())
_BWD_FUNCS = tuple(
    (f"dcn_bwd_{s}", (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                      _I, _P))
    for s in _build.SUFFIX.values())
_TILE_M, _COUT, _SMEM_MAX = 128, 64, 232448


def _clamp_args(max_offset):
    return (0.0, 0) if max_offset is None else (float(max_offset), 1)


def _check_common(name, x, offset, mask, dg):
    """Validate what both kernels read; returns (b, h, w, c)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _build.SUFFIX:
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C)")
    b, h, w, c = x.shape
    vec = 16 // x.element_size()
    if c % 16 or c % dg or (c // dg) % vec:
        raise ValueError(f"{name}: C={c} with dg={dg} needs C % 16 == 0 and "
                         f"C/dg % {vec} == 0")
    dt, dev = x.dtype, x.device
    _build.check_tensor(x, "x", (b, h, w, c), dt, dev)
    _build.check_tensor(offset, "offset", (b, h, w, dg * 18), dt, dev)
    _build.check_tensor(mask, "mask", (b, h, w, dg * 9), dt, dev)
    return b, h, w, c


def dcn_fwd_plain(x, offset, mask, weight, bias=None, deformable_groups=8,
                  act=None, max_offset=None):
    """The forward kernel's function in plain PyTorch (3x3 / s1 / p1)."""
    return modulated_deform_conv_plain(
        x, offset, mask, weight, bias, 1, 1, 1, deformable_groups,
        max_offset, act)


def dcn_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor | None = None,
            deformable_groups: int = 8, act: str | None = None,
            max_offset: float | None = None) -> torch.Tensor:
    """DCNv2 3x3 / s1 / p1 forward with fused bias and activation.

    x: (B, H, W, C) contiguous NHWC; offset: (B, H, W, dg*9*2) laid out
    (dg, tap, (dy, dx)); mask: (B, H, W, dg*9) after the sigmoid; weight
    (64, C, 3, 3); bias (64,) or None; act None / "relu" / "lrelu";
    max_offset None (exact) or R (offsets clamped to [-R, R]).  All of one
    dtype, bf16 or f32 (f32 runs the tensor cores in TF32).
    """
    if x.device.type == "cpu":
        return dcn_fwd_plain(x, offset, mask, weight, bias, deformable_groups,
                             act, max_offset)
    if act not in _build.ACTS:
        raise ValueError(f"dcn_fwd: unknown activation {act!r}")
    dg = deformable_groups
    b, h, w, c = _check_common("dcn_fwd", x, offset, mask, dg)
    if (_TILE_M + _COUT) * (c + 16 // x.element_size()) * x.element_size() \
            > _SMEM_MAX:
        raise ValueError(f"dcn_fwd: C={c} exceeds shared memory")
    dt, dev = x.dtype, x.device
    _build.check_tensor(weight, "weight", (_COUT, c, 3, 3), dt, dev)
    if bias is not None:
        _build.check_tensor(bias, "bias", (_COUT,), dt, dev)
    wk = weight.permute(0, 2, 3, 1).contiguous()  # (cout, tap, cin)
    out = torch.empty(b, h, w, _COUT, device=dev, dtype=dt)
    lib = _build.load("dcn_fwd", _FWD_FUNCS)
    with torch.cuda.device(dev):
        code = getattr(lib, f"dcn_fwd_{_build.SUFFIX[dt]}")(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, c, dg, _build.ACTS[act], *_clamp_args(max_offset),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dcn_fwd")
    dcn_fwd.launches += 1
    return out


dcn_fwd.launches = 0


def dcn_bwd_plain(x, offset, mask, weight, g, deformable_groups=8,
                  max_offset=None):
    """The backward kernel's function in plain PyTorch: the gradients of
    :func:`modulated_deform_conv_plain` (no bias, no activation) with
    output cotangent ``g``.  Returns (dx, doffset, dmask, dweight)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_()
                  for t in (x, offset, mask, weight)]
        out = modulated_deform_conv_plain(
            *leaves, None, 1, 1, 1, deformable_groups, max_offset, None)
        return torch.autograd.grad(out, leaves, g)


def dcn_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, g: torch.Tensor,
            deformable_groups: int = 8, max_offset: float | None = None):
    """DCNv2 3x3 / s1 / p1 backward: (dx, doffset, dmask, dweight) for the
    output cotangent ``g`` (B, H, W, 64), taken before bias and activation.

    Same inputs and layouts as :func:`dcn_fwd`, with C = 64.  dx and
    dweight are summed in f32 with atomics (the order of the sums changes
    from run to run) and cast to the input dtype; doffset is zero where
    the clamp cut the offset (the gate passes on [-R, R] inclusive).
    """
    if x.device.type == "cpu":
        return dcn_bwd_plain(x, offset, mask, weight, g, deformable_groups,
                             max_offset)
    dg = deformable_groups
    b, h, w, c = _check_common("dcn_bwd", x, offset, mask, dg)
    if c != _COUT:
        raise ValueError(f"dcn_bwd: the kernel takes C = {_COUT}, got {c}")
    dt, dev = x.dtype, x.device
    _build.check_tensor(weight, "weight", (_COUT, c, 3, 3), dt, dev)
    _build.check_tensor(g, "g", (b, h, w, _COUT), dt, dev)
    wt = weight.permute(1, 2, 3, 0).contiguous()  # (cin, tap, cout)
    dx = torch.zeros(b, h, w, c, device=dev, dtype=torch.float32)
    dw = torch.zeros(_COUT, 9, c, device=dev, dtype=torch.float32)
    doffset = torch.empty_like(offset)
    dmask = torch.empty_like(mask)
    lib = _build.load("dcn_bwd", _BWD_FUNCS)
    with torch.cuda.device(dev):
        code = getattr(lib, f"dcn_bwd_{_build.SUFFIX[dt]}")(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wt.data_ptr(),
            g.data_ptr(), dx.data_ptr(), doffset.data_ptr(), dmask.data_ptr(),
            dw.data_ptr(), b, h, w, dg, *_clamp_args(max_offset),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dcn_bwd")
    dcn_bwd.launches += 1
    dweight = dw.view(_COUT, 3, 3, c).permute(0, 3, 1, 2)
    return dx.to(dt), doffset, dmask, dweight.to(dt)


dcn_bwd.launches = 0


class _DCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, dg, act, max_offset):
        out = dcn_fwd(x, offset, mask, weight, bias, dg, act, max_offset)
        ctx.save_for_backward(x, offset, mask, weight,
                              None if act is None else out)
        ctx.conf = (dg, act, max_offset, bias is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight, out = ctx.saved_tensors
        dg, act, max_offset, has_bias = ctx.conf
        g_pre = act_grad(g, out, act).contiguous()
        dx, doffset, dmask, dweight = dcn_bwd(x, offset, mask, weight, g_pre,
                                              dg, max_offset)
        dbias = (g_pre.float().sum((0, 1, 2)).to(g.dtype) if has_bias
                 else None)
        return dx, doffset, dmask, dweight, dbias, None, None, None


def dcn_autograd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor | None = None,
                 deformable_groups: int = 8, act: str | None = None,
                 max_offset: float | None = None) -> torch.Tensor:
    """Differentiable :func:`dcn_fwd`: forward :func:`dcn_fwd`, backward
    :func:`dcn_bwd` (the kernels for a CUDA tensor, their plain versions for
    a CPU tensor)."""
    return _DCN.apply(x, offset, mask, weight, bias, deformable_groups, act,
                      max_offset)
