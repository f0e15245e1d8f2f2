"""How far a kernel may stray from its plain version on the same inputs.

The kernel and the plain version add the same products in different orders
in f32, so beyond that the difference comes from rounding:

  * bf16: both round the tensor-core operands to bf16 the same way; the
    outputs then differ by at most the final rounding to bf16 (one more for
    a residual added after the cast): two bf16 ulps at the output's largest
    magnitude, 2**-6 * max(1, max|ref|).
  * f32: the kernel runs the tensor cores in TF32 (10-bit mantissa, operands
    rounded to nearest, relative error <= 2**-11 each) while the plain
    version is full f32; over K = 576 to 1152 products of either sign the
    error stays well under 5e-3 * max(1, max|ref|).

Gradients (:func:`grad_tolerance`, relative to the largest magnitude of
each output, as gradients are often far below 1):

  * bf16: the DCN backward kernel and its plain version round dS to bf16
    from f32 sums taken in different orders, so single elements may differ
    by a bf16 ulp (2**-8); dx sums up to 36 such terms (4 corners x 9 taps),
    doffset and dmask 8 channels, and each result is rounded to bf16 again:
    2**-5 * max|ref|.
  * f32: TF32 operands in dS and dW as above: 5e-3 * max|ref|.

The conv3x3 backward runs cuDNN's data and weight gradients in the input
dtype; against autograd of the f32-widened plain version it differs by the
same bf16 roundings, and the same bound holds.  Its backward takes the
activation's slope from the kernel's output, and where a pre-activation lies
within the kernel's rounding of 0 (TF32 in f32) the kernel and the plain
version may take different sides, which moves single gradient elements by
their whole size.  So the plain gradients it is held against take the slope
from the kernel's output too (:func:`conv3x3_plain_grads`), and the slopes
themselves are held against the plain f32 pre-activation everywhere outside
that rounding (:func:`slope_mismatches`).
"""
from __future__ import annotations

import torch

from realvsr_tpu_torch.ops.deform_conv import act_grad
from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3_plain

_REL = {torch.bfloat16: 2.0 ** -6, torch.float32: 5e-3}


def tolerance(ref: torch.Tensor) -> float:
    """Largest max-abs error allowed against the plain output ``ref``."""
    return _REL[ref.dtype] * max(1.0, ref.float().abs().max().item())


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()


_GRAD_REL = {torch.bfloat16: 2.0 ** -5, torch.float32: 5e-3}


def grad_tolerance(ref: torch.Tensor) -> float:
    """Largest max-abs error allowed for a gradient against its plain
    ``ref``."""
    return _GRAD_REL[ref.dtype] * ref.float().abs().max().item()


def conv3x3_plain_grads(out, cot, leaves, x, weight, bias=None, act=None,
                        residual=None, x2=None):
    """Autograd of :func:`conv3x3_plain` for the output cotangent ``cot``,
    w.r.t. ``leaves``, with the activation's slope taken from the kernel's
    output ``out``."""
    pre = conv3x3_plain(x, weight, bias, None, residual, x2)
    return torch.autograd.grad(pre, leaves, act_grad(cot, out.detach(), act))


def slope_mismatches(out, x, weight, bias=None, act=None, x2=None):
    """(elements whose activation slope from the kernel's output ``out``
    differs from that of the plain f32 pre-activation, elements left out):
    those whose pre-activation lies within :func:`tolerance` of 0 are left
    out."""
    f32 = [None if t is None else t.float() for t in (x, weight, bias, x2)]
    pre = conv3x3_plain(f32[0], f32[1], f32[2], None, None, f32[3])
    near = pre.abs() <= tolerance(pre.to(out.dtype))
    ones = torch.ones_like(pre)
    differ = act_grad(ones, out.float(), act) != act_grad(ones, pre, act)
    return int((differ & ~near).sum()), int(near.sum())
