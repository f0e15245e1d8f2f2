"""Pixel losses over NHWC tensors.

Counterparts of ``realvsr_tpu/losses/basic.py``, whose numerics follow the
reference ``codes/models/loss.py``: Charbonnier with eps = 1e-6 inside the
sqrt (loss.py:17-23), Huber with delta = 1e-2 (loss.py:26-41) and the
Sobel gradient-weighted L1 (loss.py:54-80).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    return x.mean() if reduction == "mean" else x.sum()


def l1_loss(x, y, reduction="mean"):
    return _reduce((x - y).abs(), reduction)


def l2_loss(x, y, reduction="mean"):
    return _reduce((x - y) ** 2, reduction)


def charbonnier_loss(x, y, eps: float = 1e-6, reduction="mean"):
    diff = x - y
    return _reduce(torch.sqrt(diff * diff + eps), reduction)


def huber_loss(x, y, delta: float = 1e-2, reduction="mean"):
    abs_diff = (x - y).abs()
    q = torch.clamp(abs_diff, max=delta)
    return _reduce(0.5 * q ** 2 + delta * (abs_diff - q), reduction)


_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _sobel(x: torch.Tensor, kernel) -> torch.Tensor:
    c = x.shape[-1]
    w = torch.tensor(kernel, dtype=x.dtype, device=x.device).expand(c, 1, 3, 3)
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1,
                    groups=c).permute(0, 2, 3, 1)


def gw_loss(x1, x2, w: float = 4.0, reduction="mean"):
    """Gradient-weighted L1 (loss.py:54-80): (1+w|dIx|)(1+w|dIy|)|x1-x2|."""
    dx = (_sobel(x1, _SOBEL_X) - _sobel(x2, _SOBEL_X)).abs()
    dy = (_sobel(x1, _SOBEL_Y) - _sobel(x2, _SOBEL_Y)).abs()
    return _reduce((1 + w * dx) * (1 + w * dy) * (x1 - x2).abs(), reduction)


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation on NHWC (loss.py:44-51): the sum of absolute
    differences of horizontal and vertical neighbours over the whole batch
    (a sum, not a mean, as ``realvsr_tpu/losses/basic.py::tv_loss``)."""
    return ((x[:, :, :-1, :] - x[:, :, 1:, :]).abs().sum()
            + (x[:, :-1, :, :] - x[:, 1:, :, :]).abs().sum())


def style_loss(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Gram-matrix MSE (loss.py:83-99) on NHWC features; the target's Gram
    matrix carries no gradient.  The Gram matrix is over the (B * C, H * W)
    view, cross-image terms included, as the JAX package takes it."""
    def gram(v):
        b, h, w, c = v.shape
        feats = v.permute(0, 3, 1, 2).reshape(b * c, h * w)
        return feats @ feats.T / (b * c * h * w)

    return ((gram(x) - gram(target).detach()) ** 2).mean()
