"""Kernel 1: DCNv2 forward on Hopper (``csrc/dcn_fwd.cu``).

Replaces ``realvsr_tpu/ops/pallas/dcn_frame_kernel.py::dcn_frame_fused``
(input prep ``realvsr_tpu/ops/deform_conv_block.py::_frame_prep``).  Bound on
the H100 by memory: at the L1 shape (3, 512, 1024, 64) the function moves
~1.1 GB (x, offset, mask, out) for 116 GFLOP.  The kernel keeps the sampled
columns in shared memory, so each input is read from device memory about
once, and runs the tap products on the tensor cores (``mma.sync``); see the
source for the design.  Positions are exact f32: the TPU kernel's int16
fixed-point positions and lane panels are not carried over.

:func:`dcn_fwd` launches the kernel for a CUDA tensor and counts the launch
in ``dcn_fwd.launches``; for a CPU tensor it runs :func:`dcn_fwd_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
from realvsr_tpu_torch.ops.kernels import _build

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FUNCS = tuple(
    (f"dcn_fwd_{s}", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I,
                      _P))
    for s in _build.SUFFIX.values())
_TILE_M, _COUT, _SMEM_MAX = 128, 64, 232448


def dcn_fwd_plain(x, offset, mask, weight, bias=None, deformable_groups=8,
                  act=None, max_offset=None):
    """The kernel's function in plain PyTorch (3x3 / stride 1 / pad 1)."""
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
    if not x.is_cuda:
        raise ValueError(f"dcn_fwd: no kernel for device {x.device}")
    if x.dtype not in _build.SUFFIX:
        raise ValueError(f"dcn_fwd: dtype {x.dtype} not supported")
    if act not in _build.ACTS:
        raise ValueError(f"dcn_fwd: unknown activation {act!r}")
    if x.dim() != 4:
        raise ValueError("dcn_fwd: x must be (B, H, W, C)")
    b, h, w, c = x.shape
    dg = deformable_groups
    vec = 16 // x.element_size()
    if c % 16 or c % dg or (c // dg) % vec:
        raise ValueError(f"dcn_fwd: C={c} with dg={dg} needs C % 16 == 0 and "
                         f"C/dg % {vec} == 0")
    if (_TILE_M + _COUT) * (c + vec) * x.element_size() > _SMEM_MAX:
        raise ValueError(f"dcn_fwd: C={c} exceeds shared memory")
    dt, dev = x.dtype, x.device
    _build.check_tensor(x, "x", (b, h, w, c), dt, dev)
    _build.check_tensor(offset, "offset", (b, h, w, dg * 18), dt, dev)
    _build.check_tensor(mask, "mask", (b, h, w, dg * 9), dt, dev)
    _build.check_tensor(weight, "weight", (_COUT, c, 3, 3), dt, dev)
    if bias is not None:
        _build.check_tensor(bias, "bias", (_COUT,), dt, dev)
    wk = weight.permute(0, 2, 3, 1).contiguous()  # (cout, tap, cin)
    out = torch.empty(b, h, w, _COUT, device=dev, dtype=dt)
    lib = _build.load("dcn_fwd", _FUNCS)
    with torch.cuda.device(dev):
        code = getattr(lib, f"dcn_fwd_{_build.SUFFIX[dt]}")(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wk.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, h, w, c, dg, _build.ACTS[act],
            0.0 if max_offset is None else float(max_offset),
            0 if max_offset is None else 1,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dcn_fwd")
    dcn_fwd.launches += 1
    return out


dcn_fwd.launches = 0
