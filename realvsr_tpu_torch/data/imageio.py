"""Host-side image IO (the reading half of the reference ``codes/data/util.py``).

Images are read with cv2 as BGR float32 in [0, 1] (data/util.py:86-101) and
converted to the channel order the datasets emit (the reference flips
BGR→RGB before tensorization; for YCbCr-prepared data that yields
(Y, Cb, Cr)).  Same functions as ``realvsr_tpu/data/imageio.py``.
"""
from __future__ import annotations

import glob
import os
import os.path as osp

import cv2
import numpy as np

from realvsr_tpu_torch.ops.color import bgr2ycbcr_np

IMG_EXTENSIONS = (".jpg", ".JPG", ".jpeg", ".JPEG", ".png", ".PNG", ".ppm",
                  ".PPM", ".bmp", ".BMP")


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)


def read_img(path: str) -> np.ndarray:
    """Read an image as BGR float32 [0, 1], HWC (data/util.py:86-101)."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    img = img.astype(np.float32) / 255.0
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] > 3:
        img = img[:, :, :3]
    return img


def read_gray(path: str) -> np.ndarray:
    """Read an image as grayscale float64 in [0, 255] (cv2's own 8-bit
    conversion, as the reference's no-reference metrics read frames)."""
    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float64)


def channel_convert(in_c: int, tar_type, img_list):
    """BGR/gray/y conversion (data/util.py:312-323); unknown types pass
    through unchanged (the reference behaviour relied on for 'ycbcr'
    pre-converted data)."""
    if in_c == 3 and tar_type == "gray":
        return [cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)[:, :, None] for img in img_list]
    if in_c == 3 and tar_type == "y":
        return [bgr2ycbcr_np(img, only_y=True)[:, :, None] for img in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [cv2.cvtColor(img, cv2.COLOR_GRAY2BGR) for img in img_list]
    return img_list


def read_img_seq(path, color: str | None = None) -> np.ndarray:
    """Read a folder (or list) of frames → (T, H, W, C) float32, channels
    flipped to RGB order (data/util.py:104-122)."""
    if isinstance(path, list):
        paths = path
    else:
        paths = sorted(glob.glob(osp.join(path, "*")))
        paths = [p for p in paths if is_image_file(p)]
    imgs = [read_img(p) for p in paths]
    if color:
        imgs = channel_convert(imgs[0].shape[2], color, imgs)
    stack = np.stack(imgs, axis=0)
    if stack.shape[-1] == 3:
        stack = stack[..., ::-1]  # BGR → RGB channel order
    return np.ascontiguousarray(stack)


def write_img(path: str, img: np.ndarray) -> None:
    """Write HWC float [0,1] (BGR order) or uint8 image."""
    os.makedirs(osp.dirname(path), exist_ok=True)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0, 0, 255).round().astype(np.uint8)
    cv2.imwrite(path, img)
