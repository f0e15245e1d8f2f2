"""Resizing ops on NHWC tensors: torch-convention bilinear and pixel
shuffle; and the host-side MATLAB-exact bicubic of the data pipeline.

Counterparts of ``realvsr_tpu/ops/resize.py``.  The public layout stays
channels-last ``(..., H, W, C)``; a bilinear resize is one
``F.interpolate`` (``mode="bilinear", align_corners=False``, half-pixel
centres), the convention EDVR uses throughout.  :func:`matlab_imresize_np`
is MATLAB ``imresize`` (the reference's ``codes/data/util.py:510-710``) as
two dense separable weight matrices with the symmetric boundary extension
folded in, applied in numpy float64 (the motion-synthetic dataset's x1/s
LQ frames).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def _cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB bicubic kernel, a = -0.5 (data/util.py:511-516)."""
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return (1.5 * ax3 - 2.5 * ax2 + 1.0) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4.0 * ax + 2.0
    ) * ((ax > 1) & (ax <= 2))


@lru_cache(maxsize=64)
def _matlab_resize_matrix(in_length: int, out_length: int, scale: float,
                          antialiasing: bool = True) -> np.ndarray:
    """Dense (out_length, in_length) MATLAB-bicubic resize matrix: the
    reference's calculate_weights_indices (data/util.py:519-571) and its
    symmetric padding, boundary taps folded onto their mirrored source
    pixels.  Cached: callers must not write to it."""
    kernel_width = 4.0
    if scale < 1 and antialiasing:
        kernel_width = kernel_width / scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p, dtype=np.float64)[None, :]
    dist = u[:, None] - indices
    if scale < 1 and antialiasing:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # trim all-zero edge columns (the reference's rule)
    zero_cols = (weights == 0).sum(axis=0)
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        indices, weights = indices[:, 1:], weights[:, 1:]
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        indices, weights = indices[:, :-1], weights[:, :-1]

    # MATLAB indexes a symmetrically mirrored signal: map each (possibly
    # out-of-range) 1-based tap to its mirrored in-range 0-based pixel
    idx0 = indices.astype(np.int64) - 1
    mirrored = np.where(idx0 < 0, -idx0 - 1, idx0)
    mirrored = np.where(mirrored >= in_length, 2 * in_length - 1 - mirrored,
                        mirrored)
    mat = np.zeros((out_length, in_length), dtype=np.float64)
    rows = np.repeat(np.arange(out_length), weights.shape[1])
    np.add.at(mat, (rows, mirrored.reshape(-1)), weights.reshape(-1))
    return mat.astype(np.float32)


def matlab_imresize_np(img: np.ndarray, scale: float,
                       antialiasing: bool = True) -> np.ndarray:
    """MATLAB-exact bicubic ``imresize`` of an HWC image by ``scale``
    (output ceil(H * scale) x ceil(W * scale)), in float64; returns the
    input's dtype (float64 for uint8)."""
    h, w = img.shape[0], img.shape[1]
    out_h, out_w = math.ceil(h * scale), math.ceil(w * scale)
    mh = _matlab_resize_matrix(h, out_h, float(scale), antialiasing)
    mw = _matlab_resize_matrix(w, out_w, float(scale), antialiasing)
    x = img.astype(np.float64)
    x = np.einsum("oh,hwc->owc", mh, x)
    x = np.einsum("ow,hwc->hoc", mw, x)
    return x.astype(img.dtype if img.dtype != np.uint8 else np.float64)


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
