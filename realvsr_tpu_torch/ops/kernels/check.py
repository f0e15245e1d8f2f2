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
"""
from __future__ import annotations

import torch

_REL = {torch.bfloat16: 2.0 ** -6, torch.float32: 5e-3}


def tolerance(ref: torch.Tensor) -> float:
    """Largest max-abs error allowed against the plain output ``ref``."""
    return _REL[ref.dtype] * max(1.0, ref.float().abs().max().item())


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    return (out.float() - ref.float()).abs().max().item()
