"""Pyramid decomposition losses (reference loss.py:160-224), NHWC;
counterparts of ``realvsr_tpu/losses/pyramid.py``."""
from __future__ import annotations

from realvsr_tpu_torch.losses.basic import (charbonnier_loss, huber_loss,
                                            l1_loss, l2_loss)
from realvsr_tpu_torch.losses.ssim import ssim_loss
from realvsr_tpu_torch.ops.pyramid import (gau_pyramid, lap_pyramid,
                                           laplacian_pyramid)

_BASE = {
    "l1": l1_loss,
    "l2": l2_loss,
    "hb": huber_loss,
    "cb": charbonnier_loss,
}


def pyramid_loss(x, y, num_levels: int = 3, pyr_mode: str = "gau",
                 loss_mode: str = "l1", reduction: str = "mean"):
    """Sum of a base loss over pyramid levels (loss.py:160-192)."""
    if pyr_mode not in ("gau", "lap"):
        raise ValueError(f"unknown pyramid mode {pyr_mode!r}")
    base = _BASE[loss_mode]
    pyr = gau_pyramid if pyr_mode == "gau" else lap_pyramid
    loss = 0.0
    for a, b in zip(pyr(x, max_levels=num_levels),
                    pyr(y, max_levels=num_levels)):
        loss = loss + base(a, b, reduction=reduction)
    return loss


def lap_pyr_loss(x, y, num_levels: int = 3, lf_mode: str = "ssim",
                 hf_mode: str = "cb", reduction: str = "mean"):
    """LF loss on the pyramid base + HF loss on the residual levels
    (loss.py:195-224); the paper's default Y-channel criterion."""

    def pick(mode):
        if mode == "ssim":
            return lambda a, b: ssim_loss(a, b)
        return lambda a, b: _BASE[mode](a, b, reduction=reduction)

    lf, hf = pick(lf_mode), pick(hf_mode)
    px = laplacian_pyramid(x, max_levels=num_levels)
    py = laplacian_pyramid(y, max_levels=num_levels)
    loss = lf(px[-1], py[-1])
    for i in range(num_levels - 1):
        loss = loss + hf(px[i], py[i])
    return loss
