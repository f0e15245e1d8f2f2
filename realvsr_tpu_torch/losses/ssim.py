"""Differentiable SSIM / MS-SSIM losses on NHWC tensors in [0, 1].

Counterparts of ``realvsr_tpu/losses/ssim.py``, which follows
``IQA_pytorch.SSIM`` as the reference uses it (loss.py:7, 202-209): an
11-tap gaussian window of sigma 1.5, VALID filtering, unit data range
(C1 = 0.01², C2 = 0.03²), MATLAB-style average-pool downsampling by
``f = max(1, round(min(H, W) / 256))``, and ``1 - mean(ssim)`` as the loss.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _fspecial_gauss(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g = np.outer(g, g)
    return (g / g.sum()).astype(np.float32)


def _filter_valid(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID filtering of NCHW ``x``."""
    c = x.shape[1]
    return F.conv2d(x, win.expand(c, 1, *win.shape), groups=c)


def _window(x: torch.Tensor, win_size: int, win_sigma: float):
    return torch.from_numpy(_fspecial_gauss(win_size, win_sigma)).to(
        device=x.device, dtype=x.dtype)


def ssim_value(x, y, win_size: int = 11, win_sigma: float = 1.5,
               downsample: bool = True) -> torch.Tensor:
    """Per-image SSIM, NHWC in [0, 1] → (B,)."""
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    if downsample:
        f = max(1, round(min(x.shape[2], x.shape[3]) / 256))
        if f > 1:
            x, y = F.avg_pool2d(x, f), F.avg_pool2d(y, f)
    if x.shape[2] < win_size or x.shape[3] < win_size:
        raise ValueError(
            f"ssim: input {x.shape[2]}x{x.shape[3]} smaller than the "
            f"{win_size}-tap window (VALID filtering would be empty; with "
            "the lappyr criterion this needs crops >= 4*11 px)")
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    win = _window(x, win_size, win_sigma)
    mu1, mu2 = _filter_valid(x, win), _filter_valid(y, win)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = _filter_valid(x * x, win) - mu1_sq
    sigma2_sq = _filter_valid(y * y, win) - mu2_sq
    sigma12 = _filter_valid(x * y, win) - mu1_mu2
    cs_map = (2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map
    return ssim_map.mean(dim=(1, 2, 3))


def ssim_loss(x, y, **kwargs) -> torch.Tensor:
    """1 - mean SSIM (IQA_pytorch SSIM.forward(as_loss=True))."""
    return 1.0 - ssim_value(x, y, **kwargs).mean()


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def ms_ssim_value(x, y, win_size: int = 11, win_sigma: float = 1.5
                  ) -> torch.Tensor:
    """Multi-scale SSIM (5 scales, standard weights), NHWC in [0, 1]."""
    x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    win = _window(x, win_size, win_sigma)
    levels = len(_MSSSIM_WEIGHTS)
    mcs = []
    for i in range(levels):
        if i > 0:
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
        mu1, mu2 = _filter_valid(x, win), _filter_valid(y, win)
        sigma1_sq = _filter_valid(x * x, win) - mu1 ** 2
        sigma2_sq = _filter_valid(y * y, win) - mu2 ** 2
        sigma12 = _filter_valid(x * y, win) - mu1 * mu2
        cs = ((2 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)).mean(
            dim=(1, 2, 3))
        if i == levels - 1:
            lum = ((2 * mu1 * mu2 + c1) / (mu1 ** 2 + mu2 ** 2 + c1)).mean(
                dim=(1, 2, 3))
            mcs.append(torch.clamp(lum * cs, min=0.0))
        else:
            mcs.append(torch.clamp(cs, min=0.0))
    w = torch.tensor(_MSSSIM_WEIGHTS, dtype=x.dtype, device=x.device)
    return torch.prod(torch.stack(mcs) ** w[:, None], dim=0)


def ms_ssim_loss(x, y, **kwargs) -> torch.Tensor:
    return 1.0 - ms_ssim_value(x, y, **kwargs).mean()
