"""General utilities (the reference's remaining ``codes/utils/util.py`` and
``codes/data/util.py`` helpers): experiment archival, seeding, image /
tensor conversion, cropping, DUF downsampling, a progress bar and the
video helpers.

Counterpart of ``realvsr_tpu/utils/util.py``.  Images are HWC numpy arrays
and tensors are channels-last, the port's layout: :func:`img2tensor` gives
an (H, W, C) float32 tensor, :func:`tensor2img` takes one (on any device),
and :func:`duf_downsample` takes (B, H, W, C) on its device.
"""
from __future__ import annotations

import os
import os.path as osp
import random
import shutil
import subprocess
import time
from datetime import datetime

import numpy as np
import torch
import torch.nn.functional as F


def get_timestamp() -> str:
    return datetime.now().strftime("%y%m%d-%H%M%S")


def mkdir_and_rename(path: str) -> None:
    """Archive an existing experiment dir with a timestamp suffix, then
    create a fresh one (utils/util.py:69-76)."""
    if osp.exists(path):
        new_name = path + "_archived_" + get_timestamp()
        print(f"Path already exists. Rename it to [{new_name:s}]")
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def set_random_seed(seed: int) -> None:
    """Seed the host RNGs and torch's (utils/util.py:79-83); the port's
    entry points also take explicit generators derived from the config
    seed."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def img2tensor(img: np.ndarray) -> torch.Tensor:
    """HWC BGR float [0, 1] -> (T)HWC RGB float32 tensor (channels-last;
    the NHWC analog of utils/util.py img2tensor)."""
    if img.shape[-1] == 3:
        img = img[..., ::-1]
    return torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32))


def tensor2img(tensor, out_type=np.uint8, min_max=(0, 1),
               reverse_channel: bool = True) -> np.ndarray:
    """An (H, W, C) tensor or array -> uint8 (or ``out_type``) HWC image
    (utils/util.py:139-181, channels-last).  ``reverse_channel`` flips RGB
    to BGR for cv2; YCbCr data passes with ``reverse_channel=False`` as in
    the reference."""
    if isinstance(tensor, torch.Tensor):
        tensor = tensor.detach().float().cpu().numpy()
    img = np.asarray(tensor, dtype=np.float32)
    img = np.clip((img - min_max[0]) / (min_max[1] - min_max[0]), 0, 1)
    if reverse_channel and img.ndim == 3 and img.shape[-1] == 3:
        img = img[..., ::-1]
    if out_type == np.uint8:
        return (img * 255.0).round().astype(np.uint8)
    return img.astype(out_type)


def crop_border(img_list, crop_border_px: int):
    """Crop the borders of HWC images (the test scripts' util.crop_border)."""
    if crop_border_px == 0:
        return img_list
    return [v[crop_border_px:-crop_border_px, crop_border_px:-crop_border_px]
            for v in img_list]


def modcrop(img_in: np.ndarray, scale: int) -> np.ndarray:
    """Crop H, W to multiples of ``scale`` (data/util.py:419-432)."""
    img = np.copy(img_in)
    if img.ndim not in (2, 3):
        raise ValueError(f"Wrong img ndim: [{img.ndim:d}].")
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


def duf_kernel(scale: int) -> np.ndarray:
    """The DUF protocol's 13x13 blur: a scipy ``gaussian_filter``-smoothed
    delta of sigma 0.4 * scale (truncated at radius int(4 sigma + 0.5)
    inside the window, not an analytic gaussian)."""
    from scipy.ndimage import gaussian_filter

    delta = np.zeros((13, 13))
    delta[6, 6] = 1.0
    return gaussian_filter(delta, 0.4 * scale).astype(np.float32)


def duf_downsample(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """DUF protocol downsampling of (B, H, W, C): the 13-tap blur of
    :func:`duf_kernel` on reflect-padded frames, then decimation
    (utils/util.py:188-219).  As the reference, at scale 3 the bottom and
    right are reflect-extended by ``3 - dim % 3`` more rows / columns (a
    full 3 when already divisible), so sizes come out
    ceil((dim + pad) / 3)."""
    if scale not in (2, 3, 4):
        raise ValueError(f"scale [{scale}] is not supported")
    b, h, w, c = x.shape
    r = 6
    r_h = r_w = 0
    if scale == 3:
        r_h, r_w = 3 - (h % 3), 3 - (w % 3)
    xin = F.pad(x.permute(0, 3, 1, 2), (r, r + r_w, r, r + r_h),
                mode="reflect")
    k = torch.from_numpy(duf_kernel(scale)).to(x.device, x.dtype)
    out = F.conv2d(xin, k.expand(c, 1, 13, 13), groups=c)
    return out[:, :, ::scale, ::scale].permute(0, 2, 3, 1)


class ProgressBar:
    """Minimal terminal progress reporter (utils/util.py:337-384)."""

    def __init__(self, task_num: int = 0, start: bool = True):
        self.task_num = task_num
        self.completed = 0
        if start:
            self.start()

    def start(self):
        self.start_time = time.time()

    def update(self, msg: str = "In progress..."):
        self.completed += 1
        elapsed = max(time.time() - self.start_time, 1e-9)
        fps = self.completed / elapsed
        if self.task_num:
            pct = self.completed / self.task_num
            eta = int(elapsed * (1 - pct) / max(pct, 1e-9) + 0.5)
            print(f"[{self.completed}/{self.task_num}] {fps:.1f} task/s, "
                  f"elapsed {int(elapsed)}s, ETA {eta}s  {msg}", flush=True)
        else:
            print(f"completed {self.completed}, {fps:.1f} task/s",
                  flush=True)


def _ffmpeg() -> str:
    found = shutil.which("ffmpeg")
    if found is None:
        raise RuntimeError("the ffmpeg binary is not on PATH; install "
                           "ffmpeg to encode videos")
    return found


def encode_video_with_ffmpeg(src_pattern: str, dst_path: str, crf: int,
                             fps: int = 25, start_number: int = 1,
                             vframes: int = 1000) -> int:
    """x265 encode of a PNG sequence (utils/util.py:449-454) with the ffmpeg
    binary; returns its exit code."""
    cmd = [_ffmpeg(), "-r", str(fps), "-f", "image2", "-start_number",
           str(start_number), "-i", src_pattern, "-vframes", str(vframes),
           "-vcodec", "libx265", "-vf", f"fps={fps}", "-crf", str(crf),
           "-pix_fmt", "yuv420p", "-an", dst_path, "-y"]
    return subprocess.run(cmd).returncode


def extract_frames_with_ffmpeg(video_path: str, image_path: str) -> int:
    """Dump a video's frames to ``<image_path>/<k>.png`` (1-based, 5 digits)
    through cv2's decoder (utils/util.py:457-483 without ffmpeg-python);
    returns the number of frames.  Raises if the video does not open."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {video_path} (is it there, "
                           "and can cv2's decoder read it?)")
    os.makedirs(image_path, exist_ok=True)
    k = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        k += 1
        cv2.imwrite(osp.join(image_path, f"{k:05d}.png"), frame)
    cap.release()
    return k
