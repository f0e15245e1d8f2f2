"""MATLAB-compatible color-space transforms.

Reproduces the numerics of the reference's ``codes/data/util.py:326-416``
(rgb2ycbcr / bgr2ycbcr / ycbcr2rgb / ycbcr2bgr, MATLAB coefficient
conventions) over channels-last images.  Float inputs are in [0, 1]; uint8
inputs are in [0, 255] and are rounded on output.  The numpy converters
(``*_np``, host side) and the tensor ones (either device, f32 arithmetic,
differentiable for float inputs, so losses can take them) of
``realvsr_tpu/ops/color.py``, copied so this package stands alone.
"""
from __future__ import annotations

import numpy as np
import torch

# MATLAB ITU-R BT.601 coefficients for the [0,255] range.
_RGB2YCBCR_MAT = np.array(
    [
        [65.481, -37.797, 112.0],
        [128.553, -74.203, -93.786],
        [24.966, 112.0, -18.214],
    ],
    dtype=np.float64,
)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], dtype=np.float64)

# Inverse transform, in MATLAB's ycbcr2rgb parameterization
# (reference data/util.py:388-389).
_YCBCR2RGB_MAT = np.array(
    [
        [0.00456621, 0.00456621, 0.00456621],
        [0.0, -0.00153632, 0.00791071],
        [0.00625893, -0.00318811, 0.0],
    ],
    dtype=np.float64,
)
_YCBCR2RGB_OFFSET = np.array([-222.921, 135.576, -276.836], dtype=np.float64)


def rgb2ycbcr_np(img: np.ndarray, only_y: bool = False) -> np.ndarray:
    in_dtype = img.dtype
    x = img.astype(np.float64)
    if in_dtype != np.uint8:
        x = x * 255.0
    if only_y:
        y = x @ (_RGB2YCBCR_MAT[:, 0] / 255.0) + 16.0
    else:
        y = x @ (_RGB2YCBCR_MAT / 255.0) + _YCBCR_OFFSET
    if in_dtype == np.uint8:
        return np.clip(np.round(y), 0, 255).astype(in_dtype)
    return (y / 255.0).astype(in_dtype)


def bgr2ycbcr_np(img: np.ndarray, only_y: bool = False) -> np.ndarray:
    return rgb2ycbcr_np(img[..., ::-1], only_y=only_y)


def ycbcr2rgb_np(img: np.ndarray) -> np.ndarray:
    in_dtype = img.dtype
    x = img.astype(np.float64)
    if in_dtype != np.uint8:
        x = x * 255.0
    y = x @ (_YCBCR2RGB_MAT * 255.0) + _YCBCR2RGB_OFFSET
    if in_dtype == np.uint8:
        return np.clip(np.round(y), 0, 255).astype(in_dtype)
    return (y / 255.0).astype(in_dtype)


def ycbcr2bgr_np(img: np.ndarray) -> np.ndarray:
    return ycbcr2rgb_np(img)[..., ::-1]


def _apply(img: torch.Tensor, mat: np.ndarray, offset) -> torch.Tensor:
    """img @ mat + offset on the channel axis in 255-range f32 arithmetic
    (``realvsr_tpu/ops/color.py::_apply``)."""
    is_uint8 = img.dtype == torch.uint8
    x = img.float()
    if not is_uint8:
        x = x * 255.0
    y = x @ torch.as_tensor(mat, dtype=torch.float32, device=img.device)
    y = y + torch.as_tensor(offset, dtype=torch.float32, device=img.device)
    if is_uint8:
        return y.round().clamp(0, 255).to(torch.uint8)
    return (y / 255.0).to(img.dtype)


def rgb2ycbcr(img: torch.Tensor, only_y: bool = False) -> torch.Tensor:
    """MATLAB rgb2ycbcr on an (..., 3) RGB tensor; ``only_y``: the Y channel
    alone, (...)."""
    if only_y:
        return _apply(img, _RGB2YCBCR_MAT[:, 0] / 255.0, 16.0)
    return _apply(img, _RGB2YCBCR_MAT / 255.0, _YCBCR_OFFSET)


def bgr2ycbcr(img: torch.Tensor, only_y: bool = False) -> torch.Tensor:
    """:func:`rgb2ycbcr` of a BGR tensor."""
    return rgb2ycbcr(img.flip(-1), only_y=only_y)


def ycbcr2rgb(img: torch.Tensor) -> torch.Tensor:
    """MATLAB ycbcr2rgb on an (..., 3) YCbCr tensor."""
    return _apply(img, _YCBCR2RGB_MAT * 255.0, _YCBCR2RGB_OFFSET)


def ycbcr2bgr(img: torch.Tensor) -> torch.Tensor:
    """:func:`ycbcr2rgb`, channels in BGR order."""
    return ycbcr2rgb(img).flip(-1)
