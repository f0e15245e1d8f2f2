"""GT sharpening (UnsharpMask) filters — rebuild of
``codes/data/util.py:435-480``; a copy of ``realvsr_tpu/data/sharpen.py``.

Host-side uint8 data-prep transforms (applied to GT frames before/while
building training data).  Unlike the reference's global-``random`` usage,
every function takes an explicit numpy Generator so results are
reproducible per key.
"""
from __future__ import annotations

import cv2
import numpy as np
from PIL import Image, ImageFilter


def unsharp_mask_gaussian(img: np.ndarray,
                          rng: np.random.Generator) -> np.ndarray:
    """PIL UnsharpMask with random radius/percent (data/util.py:435-445)."""
    radius = int(rng.integers(3, 16))
    percent = int(rng.integers(30, 111))
    pimg = Image.fromarray(img)
    dimg = pimg.filter(ImageFilter.UnsharpMask(radius=radius, percent=percent,
                                               threshold=0))
    return np.array(dimg)


def unsharp_mask_bilateral(img: np.ndarray,
                           rng: np.random.Generator) -> np.ndarray:
    """Bilateral-filter unsharp masking (data/util.py:448-467)."""
    d = int(rng.integers(3, 10))
    sigmacolor = int(rng.integers(150, 301))
    sigmaspace = int(rng.integers(150, 301))
    percent = int(rng.integers(100, 211))
    blurred = cv2.bilateralFilter(img, d, sigmacolor, sigmaspace)
    sharpened = img + (img.astype(np.float64) - blurred) * percent / 100.0
    sharpened = np.clip(sharpened, 0, 255).round().astype(np.uint8)
    return sharpened


def unsharp_mask_gd(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Randomly pick the Gaussian or bilateral variant (util.py:470-474)."""
    if rng.random() > 0.5:
        return unsharp_mask_gaussian(img, rng)
    return unsharp_mask_bilateral(img, rng)


def sharpen_gt(img: np.ndarray, rng: np.random.Generator,
               threshold: float = 1.0) -> np.ndarray:
    """Apply GT sharpening with probability ``threshold`` (util.py:477-480)."""
    if rng.random() < threshold:
        return unsharp_mask_gd(img, rng)
    return img
