"""RCAN adapted to video by flattening T x C into channels (``torch.nn``,
NHWC): the reference's ``codes/models/archs/RCAN_arch.py``.

Counterpart of ``realvsr_tpu/models/rcan.py`` under the same module names
(``body.{g}.residual_group.{b}.conv1``, ``upsample_conv{i}``).  On a CUDA
tensor every 3x3 conv on 64 (a multiple of 16) input channels runs the
hand-written conv3x3 kernel: the RCABs' two convs (relu fused into
``conv1``), each group's closing ``conv`` and ``conv_after_body`` (their
identity adds fused as residuals), the upsampler's convs and
``conv_last``.  ``conv_first`` (T x C = 9 or 15 input channels) goes to
``F.conv2d``, as do the channel attention's 1x1 convs on the pooled
vector.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from realvsr_tpu_torch.models.common import Conv2d, reset_parameters
from realvsr_tpu_torch.ops.resize import pixel_shuffle


class ChannelAttention(nn.Module):
    """Squeeze-excite channel attention (RCAN_arch.py:30-48)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16):
        super().__init__()
        self.conv1 = Conv2d(num_feat, num_feat // squeeze_factor, 1,
                            padding=0, act="relu")
        self.conv2 = Conv2d(num_feat // squeeze_factor, num_feat, 1,
                            padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.mean(dim=(1, 2), keepdim=True)
        return x * torch.sigmoid(self.conv2(self.conv1(y)))


class RCAB(nn.Module):
    """Residual channel attention block (RCAN_arch.py:51-70)."""

    def __init__(self, num_feat: int, squeeze_factor: int = 16,
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv2d(num_feat, num_feat, act="relu", kernel=True)
        self.conv2 = Conv2d(num_feat, num_feat, kernel=True)
        self.attention = ChannelAttention(num_feat, squeeze_factor)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.attention(self.conv2(self.conv1(x))) * self.res_scale


class ResidualGroup(nn.Module):
    """``num_block`` RCABs and a 3x3 conv, plus the input
    (RCAN_arch.py:73-95)."""

    def __init__(self, num_feat: int, num_block: int,
                 squeeze_factor: int = 16, res_scale: float = 1.0):
        super().__init__()
        self.residual_group = nn.Sequential(*[
            RCAB(num_feat, squeeze_factor, res_scale)
            for _ in range(num_block)])
        self.conv = Conv2d(num_feat, num_feat, kernel=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(self.residual_group(x), residual=x)


class RCAN(nn.Module):
    """``forward(x)``: a (B, T, H, W, C) window (frames flattened into T*C
    channels, frame major) or a (B, H, W, T*C) tensor -> (B, H*upscale,
    W*upscale, num_out_ch) in the compute dtype ``dtype`` (weights f32,
    drawn from ``generator`` on the CPU and moved to ``device``)."""

    def __init__(self, num_in_ch: int = 3, num_out_ch: int = 3,
                 num_frames: int = 5, num_feat: int = 64,
                 num_group: int = 10, num_block: int = 16,
                 squeeze_factor: int = 16, upscale: int = 4,
                 res_scale: float = 1.0, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        if upscale & (upscale - 1) == 0:
            self.shuffles = [2] * (upscale.bit_length() - 1)
        elif upscale == 3:
            self.shuffles = [3]
        else:
            raise ValueError(f"scale {upscale} is not supported.")
        self.conv_first = Conv2d(num_in_ch * num_frames, num_feat)
        self.body = nn.Sequential(*[
            ResidualGroup(num_feat, num_block, squeeze_factor, res_scale)
            for _ in range(num_group)])
        self.conv_after_body = Conv2d(num_feat, num_feat, kernel=True)
        for i, r in enumerate(self.shuffles):
            setattr(self, f"upsample_conv{i}",
                    Conv2d(num_feat, r * r * num_feat, kernel=True))
        self.conv_last = Conv2d(num_feat, num_out_ch, kernel=True)
        reset_parameters(self, generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 5:
            b, t, h, w, c = x.shape
            x = x.permute(0, 2, 3, 1, 4).reshape(b, h, w, t * c)
        x = self.conv_first(x.to(self.dtype))
        x = self.conv_after_body(self.body(x), residual=x)
        for i, r in enumerate(self.shuffles):
            x = pixel_shuffle(getattr(self, f"upsample_conv{i}")(x), r)
        return self.conv_last(x)
