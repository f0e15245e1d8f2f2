"""How the reference computes: float32 with TF32 off, or, as the control
that has to fail a bf16 cell's check, in fp8.

``Precision.cast`` is applied to every tensor entering a convolution or a
deformable convolution (activations and weights).  In float32 it is the
identity; with ``fp8`` each such tensor is rounded to float8 e4m3 under a
per-tensor scale (its largest magnitude mapped to e4m3's largest, 448) and
the product is taken in float32 from the rounded values, as an fp8
pipeline with float32 accumulation would compute it.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """Turn TF32 off for matrix products and cuDNN convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in float32."""
    amax = t.detach().abs().amax().float().clamp_min(1e-30)
    scale = amax / E4M3_MAX
    return (t.float() / scale).to(torch.float8_e4m3fn).float() * scale


class Precision:
    """``fp8``: round every convolution's inputs and weights to e4m3."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def cast(self, t: torch.Tensor) -> torch.Tensor:
        return round_fp8(t) if self.fp8 else t


FP32 = Precision()
