"""Image quality metrics on the host: PSNR and MATLAB-equivalent SSIM.

Numerics mirror the reference (``codes/utils/util.py:283-334``): 255-range
inputs, 11-tap Gaussian window (sigma 1.5), 'valid' crop of 5 px per side.
The numpy half of ``realvsr_tpu/ops/metrics.py``.
"""
from __future__ import annotations

import math

import numpy as np


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
