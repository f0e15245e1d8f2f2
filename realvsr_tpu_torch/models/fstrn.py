"""FSTRN, the Fast Spatio-Temporal Residual Network (``torch.nn``):
factorised 3-D convolutions over (T, H, W) video volumes (the reference's
``codes/models/archs/FSTRN_arch.py``).

Counterpart of ``realvsr_tpu/models/fstrn.py`` under the same module
names.  Its convs are 3-D (``F.conv3d`` / cuDNN on the card, as the JAX
package leaves them to XLA) and its upsampler a (1, s, s) transposed 3-D
conv; no conv here runs the conv3x3 kernel.  The cross-space residual is
the input resized trilinearly with half-pixel centres
(``F.interpolate(mode="trilinear", align_corners=False)``, what
``jax.image.resize(method="linear")`` computes when it upsamples).

Dropout: the reference has ``Dropout(0.3)`` after the LSR PReLU, and the
JAX module too, but the JAX package never turns it on: its trainer applies
BN-free models without ``train=True`` (``realvsr_tpu/train/
wrappers.py:48``, ``_forward_train``), so FSTRN trains there with the
dropout off.  The port is held to the JAX package and has no dropout, in
``train()`` as in ``eval()``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from realvsr_tpu_torch.models.common import (ConvTranspose, PReLU,
                                             _uniform_, reset_parameters)


class Conv3d(nn.Module):
    """``nn.Conv3d`` on NCDHW tensors, torch's default init
    (U(±1/sqrt(fan_in)) for weight and bias)."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, int, int],
                 padding: tuple[int, int, int]):
        super().__init__()
        self.padding = tuple(padding)
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        bound = 1 / math.sqrt(self.weight[0].numel())
        _uniform_(self.weight, bound, gen)
        _uniform_(self.bias, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv3d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        padding=self.padding)


class FRB(nn.Module):
    """Fast residual block: PReLU -> (1, k, k) conv -> (k, 1, 1) conv, plus
    the input (FSTRN_arch.py:11-22)."""

    def __init__(self, k: int = 3, nf: int = 64):
        super().__init__()
        self.prelu = PReLU()
        self.conv3d_1 = Conv3d(nf, nf, (1, k, k), (0, 1, 1))
        self.conv3d_2 = Conv3d(nf, nf, (k, 1, 1), (1, 0, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv3d_2(self.conv3d_1(self.prelu(x)))


class FSTRN(nn.Module):
    """LFENet -> 5 FRBs -> LSRNet (PReLU, conv, (1, s, s) transposed conv,
    conv to 3 channels) plus the trilinear cross-space residual; returns
    the centre frame (FSTRN_arch.py:25-69).

    ``forward(x)``: (B, T, H, W, 3) -> (B, H*scale, W*scale, 3) in the
    compute dtype ``dtype`` (weights f32, drawn from ``generator`` on the
    CPU and moved to ``device``).
    """

    def __init__(self, k: int = 3, nf: int = 64, scale: int = 4,
                 nframes: int = 5, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.scale, self.center, self.dtype = scale, nframes // 2, dtype
        kkk = (k, k, k)
        self.conv3d_fe = Conv3d(3, nf, kkk, (1, 1, 1))
        for i in range(1, 6):
            setattr(self, f"frb_{i}", FRB(k, nf))
        self.prelu = PReLU()
        self.conv3d_1 = Conv3d(nf, nf, kkk, (1, 1, 1))
        self.upsample = ConvTranspose(nf, nf, (1, scale, scale),
                                      bound=1 / math.sqrt(scale * scale * nf))
        self.conv3d_2 = Conv3d(nf, 3, kkk, (1, 1, 1))
        reset_parameters(self, generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        s = self.scale
        v = x.to(self.dtype).permute(0, 4, 1, 2, 3)    # NCDHW
        lr_res = self.conv3d_fe(v)
        out = lr_res
        for i in range(1, 6):
            out = getattr(self, f"frb_{i}")(out)
        out = self.prelu(lr_res + out)
        out = self.conv3d_2(self.upsample(self.conv3d_1(out)))
        cs = F.interpolate(v, size=(t, h * s, w * s), mode="trilinear",
                           align_corners=False)
        return (cs + out)[:, :, self.center].permute(0, 2, 3, 1).contiguous()
