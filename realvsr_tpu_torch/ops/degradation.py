"""Blur-kernel / PCA / SRMD degradation toolkit (the reference's
``codes/utils/util.py:557-1008``).

Counterpart of ``realvsr_tpu/ops/degradation.py``.  The kernel generators
and the PCA fit run on the host in numpy from an explicit
``np.random.Generator`` (a copy of the JAX module's); the batch blur, the
bicubic downscale and the noising run on the tensors' device, the noise
drawn from an explicit ``torch.Generator`` where JAX takes a key.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from realvsr_tpu_torch.ops.resize import matlab_imresize

# ---------------------------------------------------------------------------
# kernel generation (host)
# ---------------------------------------------------------------------------


def isotropic_gaussian_kernel(l: int, sigma: float) -> np.ndarray:
    """(l, l) isotropic gaussian, normalized (utils/util.py isogkern)."""
    ax = np.arange(-(l // 2), l // 2 + 1, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax)
    k = np.exp(-(xx**2 + yy**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def cal_sigma(sig_x: float, sig_y: float, radians: float) -> np.ndarray:
    """Covariance matrix of a rotated anisotropic gaussian."""
    d = np.array([[sig_x**2, 0.0], [0.0, sig_y**2]])
    u = np.array([[np.cos(radians), -np.sin(radians)],
                  [np.sin(radians), np.cos(radians)]])
    return u @ d @ u.T


def anisotropic_gaussian_kernel(l: int, sigma_matrix: np.ndarray
                                ) -> np.ndarray:
    """(l, l) anisotropic gaussian from a 2x2 covariance."""
    ax = np.arange(-(l // 2), l // 2 + 1, dtype=np.float64)
    xx, yy = np.meshgrid(ax, ax)
    xy = np.stack([xx, yy], axis=-1)
    inv = np.linalg.inv(sigma_matrix)
    k = np.exp(-0.5 * np.einsum("hwi,ij,hwj->hw", xy, inv, xy))
    return (k / k.sum()).astype(np.float32)


def random_isotropic_gaussian_kernel(rng: np.random.Generator,
                                     sig_min=0.2, sig_max=4.0, l=21):
    sig = rng.uniform(sig_min, sig_max)
    return isotropic_gaussian_kernel(l, sig), sig


def random_anisotropic_gaussian_kernel(rng: np.random.Generator,
                                       sig_min=0.2, sig_max=4.0,
                                       scaling=3, l=21):
    theta = rng.uniform(0, np.pi)
    sig_x = rng.uniform(sig_min, sig_max)
    sig_y = np.clip(sig_x * rng.uniform(1.0 / scaling, 1.0), sig_min,
                    sig_max)
    return anisotropic_gaussian_kernel(l, cal_sigma(sig_x, sig_y, theta))


def random_gaussian_kernel(rng: np.random.Generator, l=21, sig_min=0.2,
                           sig_max=4.0, rate_iso=1.0, scaling=3):
    """Isotropic with probability ``rate_iso``, else anisotropic
    (utils/util.py random_gaussian_kernel)."""
    if rng.random() < rate_iso:
        return random_isotropic_gaussian_kernel(rng, sig_min, sig_max, l)[0]
    return random_anisotropic_gaussian_kernel(rng, sig_min, sig_max,
                                              scaling, l)


def random_batch_kernel(rng: np.random.Generator, batch: int, l=21,
                        sig_min=0.2, sig_max=4.0, rate_iso=1.0,
                        scaling=3) -> np.ndarray:
    return np.stack([
        random_gaussian_kernel(rng, l, sig_min, sig_max, rate_iso, scaling)
        for _ in range(batch)])


def stable_batch_kernel(batch: int, l=21, sig=2.6) -> np.ndarray:
    k = isotropic_gaussian_kernel(l, sig)
    return np.broadcast_to(k, (batch, l, l)).copy()


def random_batch_noise(rng: np.random.Generator, batch: int, high: float,
                       rate_cln: float = 1.0) -> np.ndarray:
    """Per-example noise levels in [0, high), zeroed with probability
    ``rate_cln`` (random_batch_noise)."""
    levels = rng.uniform(0, high, size=(batch,))
    mask = rng.uniform(size=(batch,)) > rate_cln
    return (levels * mask).astype(np.float32)


# ---------------------------------------------------------------------------
# PCA kernel encoding (host fit, device apply)
# ---------------------------------------------------------------------------


def pca_fit(data: np.ndarray, k: int = 2) -> np.ndarray:
    """PCA basis of flattened kernels: data (N, D) -> (D, k) projection
    (utils/util.py PCA)."""
    x = data - data.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return vt[:k].T.astype(np.float32)


def pca_encode(kernels: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """(B, l, l) kernels -> (B, k) codes (PCAEncoder.__call__)."""
    return kernels.reshape(kernels.shape[0], -1) @ basis


# ---------------------------------------------------------------------------
# device-side degradation ops
# ---------------------------------------------------------------------------


def batch_blur(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Per-example blur (BatchBlur): x (B, H, W, C), kernels (B, l, l), the
    edges replicated (JAX's ``mode="edge"``).  One grouped convolution of
    B*C groups, each channel of example b by kernel b."""
    b, h, w, c = x.shape
    l = kernels.shape[-1]
    pad = l // 2
    xin = x.permute(0, 3, 1, 2).reshape(1, b * c, h, w)
    xin = F.pad(xin, (pad, pad, pad, pad), mode="replicate")
    weight = kernels.to(x.dtype).repeat_interleave(c, 0)[:, None]
    out = F.conv2d(xin, weight, groups=b * c)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def gaussian_noising(gen: torch.Generator, x: torch.Tensor,
                     sigma: torch.Tensor, clip_min=0.0, clip_max=1.0
                     ) -> torch.Tensor:
    """Add per-example gaussian noise of std ``sigma`` (B,) on the [0, 1]
    scale, drawn from ``gen`` (on x's device), and clip
    (b_GaussianNoising)."""
    noise = torch.randn(x.shape, generator=gen, device=x.device,
                        dtype=x.dtype)
    sigma = sigma.to(x.dtype).reshape(-1, *([1] * (x.dim() - 1)))
    return (x + noise * sigma).clamp(clip_min, clip_max)


class SRMDPreprocessing:
    """SRMD-style degradation: blur -> bicubic downscale by ``scale`` ->
    noise, with the kernels' PCA codes (+ the noise level x 10)
    (utils/util.py SRMDPreprocessing)."""

    def __init__(self, scale: int, pca_basis: np.ndarray, ksize: int = 21,
                 code_length: int = 10, random_kernel: bool = True,
                 noise: bool = False, sig: float = 2.6, sig_min: float = 0.2,
                 sig_max: float = 4.0, rate_iso: float = 1.0,
                 scaling: int = 3, rate_cln: float = 0.2,
                 noise_high: float = 0.08):
        self.scale = scale
        self.basis = np.asarray(pca_basis, np.float32)
        self.ksize = ksize
        self.random_kernel = random_kernel
        self.noise = noise
        self.sig, self.sig_min, self.sig_max = sig, sig_min, sig_max
        self.rate_iso, self.scaling = rate_iso, scaling
        self.rate_cln, self.noise_high = rate_cln, noise_high

    def __call__(self, rng: np.random.Generator, gen: torch.Generator,
                 hr: torch.Tensor):
        """(lr, codes, kernels) of the (B, H, W, C) batch ``hr``; kernels
        and noise levels from ``rng``, the noise from ``gen``."""
        b, dev = hr.shape[0], hr.device
        if self.random_kernel:
            kernels = random_batch_kernel(rng, b, self.ksize, self.sig_min,
                                          self.sig_max, self.rate_iso,
                                          self.scaling)
        else:
            kernels = stable_batch_kernel(b, self.ksize, self.sig)
        kernels_t = torch.from_numpy(kernels).to(dev)
        lr = matlab_imresize(batch_blur(hr, kernels_t), 1.0 / self.scale)
        codes = pca_encode(kernels_t, torch.from_numpy(self.basis).to(dev))
        if self.noise:
            levels = torch.from_numpy(random_batch_noise(
                rng, b, self.noise_high, self.rate_cln)).to(dev)
            lr = gaussian_noising(gen, lr, levels)
            codes = torch.cat([codes, levels[:, None] * 10.0], 1)
        return lr, codes, kernels_t
