"""Resizing ops on NHWC tensors: torch-convention bilinear and pixel shuffle.

Counterparts of ``realvsr_tpu/ops/resize.py:102-129``.  The public layout
stays channels-last ``(..., H, W, C)``; the work is one ``F.interpolate``
(``mode="bilinear", align_corners=False``, half-pixel centres), the
convention EDVR uses throughout.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centres (align_corners=False).

    x: (..., H, W, C) → (..., out_h, out_w, C), contiguous.
    """
    *lead, h, w, c = x.shape
    x4 = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)
    y = F.interpolate(x4, size=tuple(out_hw), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_hw[0], out_hw[1], c) \
        .contiguous()


def upsample2x_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample, align_corners=False convention."""
    return resize_bilinear(x, (x.shape[-3] * 2, x.shape[-2] * 2))


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """PixelShuffle with torch channel ordering on NHWC input: channels are
    viewed as (C_out, r, r) as ``nn.PixelShuffle`` views them on NCHW."""
    *lead, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(*lead, h, w, c_out, r, r)
    nl = len(lead)
    # (H, W, C_out, r_h, r_w) → (H, r_h, W, r_w, C_out)
    perm = tuple(range(nl)) + (nl + 0, nl + 3, nl + 1, nl + 4, nl + 2)
    return x.permute(perm).reshape(*lead, h * r, w * r, c_out).contiguous()
