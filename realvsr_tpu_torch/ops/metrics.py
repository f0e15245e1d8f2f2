"""Image quality metrics: PSNR and MATLAB-equivalent SSIM.

Numerics mirror the reference (``codes/utils/util.py:283-334``): 255-range
inputs, 11-tap Gaussian window (sigma 1.5), 'valid' crop of 5 px per side.
The numpy functions (``*_np``, on the host) and the tensor ones
(:func:`psnr`, :func:`ssim`, on either device, differentiable, with a
``data_range``) of ``realvsr_tpu/ops/metrics.py``.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_window_11() -> np.ndarray:
    # cv2.getGaussianKernel(11, 1.5) equivalent
    k = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5**2))
    k = k / k.sum()
    return np.outer(k, k)


def calculate_psnr_np(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0, 255]-range images (utils/util.py:283-290)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _ssim_2d_np(img1: np.ndarray, img2: np.ndarray) -> float:
    from scipy.signal import convolve2d

    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window_11()

    def filt(x):
        return convolve2d(x, window, mode="valid")

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = filt(img1**2) - mu1_sq
    sigma2_sq = filt(img2**2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim_np(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-equivalent SSIM on [0, 255] images, HxW or HxWxC
    (utils/util.py:293-334)."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_2d_np(img1, img2)
    if img1.ndim == 3:
        if img1.shape[2] == 1:
            return _ssim_2d_np(img1[..., 0], img2[..., 0])
        # the reference computes per channel, then averages
        return float(
            np.mean([_ssim_2d_np(img1[..., i], img2[..., i]) for i in range(img1.shape[2])])
        )
    raise ValueError("Wrong input image dimensions.")


def psnr(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """PSNR over the whole tensors, in f32; inputs in [0, data_range]
    (the mean squared error floored at 1e-12, as the JAX package's)."""
    mse = ((img1.float() - img2.float()) ** 2).mean()
    return 20.0 * math.log10(data_range) - 10.0 * torch.log10(
        mse.clamp_min(1e-12))


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         data_range: float = 255.0) -> torch.Tensor:
    """MATLAB-equivalent single-scale SSIM of two (H, W) images, in f32:
    the 11-tap Gaussian window over the valid region, the mean of the SSIM
    map."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    window = torch.as_tensor(_gaussian_window_11(), dtype=torch.float32,
                             device=img1.device)[None, None]

    def filt(v):
        return F.conv2d(v[None, None], window)[0, 0]

    x, y = img1.float(), img2.float()
    mu1, mu2 = filt(x), filt(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(x * x) - mu1_sq
    sigma2_sq = filt(y * y) - mu2_sq
    sigma12 = filt(x * y) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean()
