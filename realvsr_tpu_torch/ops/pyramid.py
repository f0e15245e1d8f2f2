"""Gaussian / Laplacian image pyramids on NHWC tensors.

Counterpart of ``realvsr_tpu/ops/pyramid.py``, which follows the reference's
decomposition toolkit (``codes/utils/util.py:491-554``): the fixed 5x5
binomial kernel / 256, reflect padding, decimation by ``x[:, ::2, ::2]``,
and zero-stuffed upsampling filtered with 4x the kernel.  The depthwise blur
is a grouped ``F.conv2d``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_BINOMIAL_5 = np.array(
    [
        [1.0, 4.0, 6.0, 4.0, 1.0],
        [4.0, 16.0, 24.0, 16.0, 4.0],
        [6.0, 24.0, 36.0, 24.0, 6.0],
        [4.0, 16.0, 24.0, 16.0, 4.0],
        [1.0, 4.0, 6.0, 4.0, 1.0],
    ],
    dtype=np.float64,
) / 256.0


def gauss_kernel(dtype=torch.float32, device=None) -> torch.Tensor:
    """The fixed 5x5 binomial kernel (utils/util.py:491-500), shape (5, 5)."""
    return torch.tensor(_BINOMIAL_5, dtype=dtype, device=device)


def conv_gauss(x: torch.Tensor, kernel: torch.Tensor | None = None
               ) -> torch.Tensor:
    """Depthwise 5x5 blur with reflect padding on NHWC input
    (utils/util.py:503-506)."""
    if kernel is None:
        kernel = gauss_kernel(x.dtype, x.device)
    c = x.shape[-1]
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="reflect")
    w = kernel.to(x.dtype).expand(c, 1, 5, 5)
    return F.conv2d(xp, w, groups=c).permute(0, 2, 3, 1)


def downsample(x: torch.Tensor) -> torch.Tensor:
    """Decimate by 2 (utils/util.py:509-510)."""
    return x[:, ::2, ::2, :]


def upsample(x: torch.Tensor) -> torch.Tensor:
    """Zero-stuff 2x then blur with the 4x kernel (utils/util.py:513-516)."""
    b, h, w, c = x.shape
    x_up = x.new_zeros(b, h * 2, w * 2, c)
    x_up[:, ::2, ::2, :] = x
    return conv_gauss(x_up, 4.0 * gauss_kernel(x.dtype, x.device))


def lap_pyramid(img: torch.Tensor, max_levels: int = 3) -> list[torch.Tensor]:
    """Laplacian pyramid, high-frequency residuals only
    (utils/util.py:519-529)."""
    current = img
    pyr = []
    for _ in range(max_levels):
        down = downsample(conv_gauss(current))
        pyr.append(current - upsample(down))
        current = down
    return pyr


def gau_pyramid(img: torch.Tensor, max_levels: int = 3) -> list[torch.Tensor]:
    """Gaussian pyramid including the input (utils/util.py:532-539)."""
    current = img
    pyr = [current]
    for _ in range(max_levels - 1):
        current = downsample(conv_gauss(current))
        pyr.append(current)
    return pyr


def laplacian_pyramid(img: torch.Tensor, max_levels: int = 3
                      ) -> list[torch.Tensor]:
    """Laplacian pyramid whose last level is the low-frequency base
    (utils/util.py:542-554), the decomposition of LapPyrLoss."""
    if max_levels < 2:
        raise ValueError("laplacian_pyramid needs max_levels >= 2")
    current = img
    pyr = []
    for _ in range(max_levels - 1):
        down = downsample(conv_gauss(current))
        pyr.append(current - upsample(down))
        current = down
    pyr.append(current)
    return pyr
