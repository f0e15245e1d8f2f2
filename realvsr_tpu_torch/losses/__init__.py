"""Loss registry keyed by the reference's criterion strings.

Counterpart of ``realvsr_tpu/losses/__init__.py`` (the dispatch of
``VideoSR_AllPair_model_YCbCr_Split.py:44-87``): l1 | l2 | cb | hb | gw |
pyr (gaussian pyramid + Charbonnier) | lappyr (LF-SSIM + HF-Charbonnier) |
msssim; the GAN losses (``losses/gan.py``); and, outside the registry as
in JAX, ``tv_loss`` and ``style_loss``.
"""
from __future__ import annotations

from functools import partial

from realvsr_tpu_torch.losses.basic import (charbonnier_loss, gw_loss,
                                            huber_loss, l1_loss, l2_loss,
                                            style_loss, tv_loss)
from realvsr_tpu_torch.losses.gan import gan_loss, gradient_penalty
from realvsr_tpu_torch.losses.pyramid import lap_pyr_loss, pyramid_loss
from realvsr_tpu_torch.losses.ssim import (ms_ssim_loss, ms_ssim_value,
                                           ssim_loss, ssim_value)

_REGISTRY = {
    "l1": l1_loss,
    "l2": l2_loss,
    "cb": charbonnier_loss,
    "hb": huber_loss,
    "gw": partial(gw_loss, w=4.0),
    "pyr": partial(pyramid_loss, num_levels=3, pyr_mode="gau", loss_mode="cb"),
    "lappyr": partial(lap_pyr_loss, num_levels=3, lf_mode="ssim", hf_mode="cb"),
    "msssim": ms_ssim_loss,
}


def get_pixel_criterion(name: str):
    if name not in _REGISTRY:
        raise NotImplementedError(f"Loss type [{name}] is not recognized.")
    return _REGISTRY[name]


__all__ = [
    "get_pixel_criterion", "l1_loss", "l2_loss", "charbonnier_loss",
    "huber_loss", "gw_loss", "tv_loss", "pyramid_loss", "lap_pyr_loss",
    "ssim_loss", "ssim_value", "ms_ssim_loss", "ms_ssim_value", "gan_loss",
    "style_loss", "gradient_penalty",
]
