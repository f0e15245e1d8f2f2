"""Synthetic video datasets for tests and the debug and smoke configs.

A copy of ``realvsr_tpu/data/synthetic.py`` (numpy only), with the same
random draws in the same order, so items equal the JAX package's:

* the drifting-sinusoid clips (``Synthetic`` / ``SyntheticTest``): the GT
  is a smooth moving pattern, the LQ a blurred and noisy copy;
* the motion-rich clips (``SyntheticMotion`` / ``SyntheticMotionTest``):
  textured layers under a camera pan up to ±3 px a frame, a rotating and
  zooming foreground patch moving up to ±6 px a frame with an occlusion
  edge, then a realistic degradation (two box blurs, signal-dependent
  noise, 6-bit banding) and, at ``scale`` > 1, a MATLAB-bicubic x1/scale
  LQ (the reference's ``codes/scripts/generate_LR_BI_Vimeo90K.m``).

Every frame is deterministic in (sequence, frame).  Items follow the
RealVSR datasets' schema, so the train and eval stacks run without the
dataset.
"""
from __future__ import annotations

import functools

import numpy as np

from realvsr_tpu_torch.ops.resize import matlab_imresize_np
from realvsr_tpu_torch.utils.indexing import index_generation


def _frame(seq: int, t: int, h: int, w: int) -> np.ndarray:
    """Deterministic clean frame: drifting sinusoid mixture, (H, W, 3)."""
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    phase = 0.13 * t + seq
    img = np.stack(
        [
            0.5 + 0.5 * np.sin(0.07 * xx + 0.05 * yy + phase),
            0.5 + 0.5 * np.sin(0.05 * xx - 0.06 * yy + 1.7 * phase),
            0.5 + 0.5 * np.sin(0.045 * (xx + yy) + 0.5 + phase),
        ],
        axis=-1,
    )
    return img.astype(np.float32)


def _degrade(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Box blur + mild gaussian noise as the 'real-world' LQ."""
    k = 3
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    blur = sum(
        pad[dy:dy + img.shape[0], dx:dx + img.shape[1]]
        for dy in range(k) for dx in range(k)
    ) / (k * k)
    noisy = blur + rng.normal(0, 0.01, img.shape).astype(np.float32)
    return np.clip(noisy, 0.0, 1.0).astype(np.float32)


class SyntheticVSRDataset:
    """Training dataset, AllPair schema (LQs (T,H,W,C), GT (T,H,W,C))."""

    all_pair = True

    def __init__(self, opt: dict):
        self.n_frames = opt.get("N_frames") or 3
        self.gt_size = opt.get("GT_size") or 64
        self.scale = opt.get("scale") or 1
        self.num_seqs = opt.get("num_seqs") or 8
        self.frames_per_seq = opt.get("frames_per_seq") or 10
        self.frame_h = opt.get("frame_h") or max(self.gt_size, 96)
        self.frame_w = opt.get("frame_w") or max(self.gt_size, 96)
        self.keys = [
            f"{s:03d}_{f:05d}" for s in range(self.num_seqs)
            for f in range(self.frames_per_seq)
        ]

    def __len__(self):
        return len(self.keys)

    def get(self, index: int, rng: np.random.Generator) -> dict:
        key = self.keys[index]
        seq, frame = (int(v) for v in key.split("_"))
        half = self.n_frames // 2
        neighbors = [
            int(np.clip(frame + d, 0, self.frames_per_seq - 1))
            for d in range(-half, half + 1)
        ]
        gts = [_frame(seq, t, self.frame_h, self.frame_w) for t in neighbors]
        lqs = [_degrade(g, np.random.default_rng(seq * 1000 + t))
               for g, t in zip(gts, neighbors)]
        # random crop
        rh = int(rng.integers(0, self.frame_h - self.gt_size + 1))
        rw = int(rng.integers(0, self.frame_w - self.gt_size + 1))
        gts = [v[rh:rh + self.gt_size, rw:rw + self.gt_size] for v in gts]
        lqs = [v[rh:rh + self.gt_size, rw:rw + self.gt_size] for v in lqs]
        return {
            "LQs": np.stack(lqs).astype(np.float32),
            "GT": np.stack(gts).astype(np.float32),
            "key": key,
        }

    def __getitem__(self, index: int) -> dict:
        return self.get(index, np.random.default_rng(index))


class SyntheticVideoTestDataset:
    """Eval dataset with the VideoTestDataset item schema; sequences from
    ``seq_base`` (default :attr:`SEQ_BASE`)."""

    SEQ_BASE = 0

    def _clip(self, s: int, h: int, w: int, opt: dict):
        """(GT frames, LQ frames) of sequence ``s``."""
        gts = np.stack([_frame(s, t, h, w)
                        for t in range(self.frames_per_seq)])
        lqs = np.stack([_degrade(gts[t], np.random.default_rng(s * 1000 + t))
                        for t in range(self.frames_per_seq)])
        return gts, lqs

    def __init__(self, opt: dict):
        self.n_frames = opt.get("N_frames") or 3
        self.padding = opt.get("padding") or "replicate"
        self.num_seqs = opt.get("num_seqs") or 2
        self.frames_per_seq = opt.get("frames_per_seq") or 6
        h = opt.get("frame_h") or 64
        w = opt.get("frame_w") or 64
        seq_base = opt.get("seq_base", self.SEQ_BASE)
        self.imgs_gt, self.imgs_lq = {}, {}
        self.entries = []
        for s in range(seq_base, seq_base + self.num_seqs):
            name = f"{s:03d}"
            self.imgs_gt[name], self.imgs_lq[name] = self._clip(s, h, w, opt)
            for i in range(self.frames_per_seq):
                border = int(i < self.n_frames // 2 or
                             i >= self.frames_per_seq - self.n_frames // 2)
                self.entries.append((name, i, border))

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, index: int) -> dict:
        folder, idx, border = self.entries[index]
        select = index_generation(idx, self.frames_per_seq, self.n_frames,
                                  padding=self.padding)
        return {
            "LQs": self.imgs_lq[folder][select],
            "GT": self.imgs_gt[folder][idx],
            "folder": folder,
            "idx": f"{idx}/{self.frames_per_seq}",
            "border": border,
        }


# ------------------------------------------------------------- motion-rich


def _texture(seed: int, h: int, w: int) -> np.ndarray:
    """Band-limited random RGB texture with multi-scale detail."""
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w, 3), np.float32)
    for scale in (4, 8, 16, 32):
        low = rng.random((h // scale + 2, w // scale + 2, 3)).astype(np.float32)
        yy = np.linspace(0, low.shape[0] - 1.001, h, dtype=np.float32)
        xx = np.linspace(0, low.shape[1] - 1.001, w, dtype=np.float32)
        y0 = yy.astype(np.int32)
        x0 = xx.astype(np.int32)
        ty = (yy - y0)[:, None, None]
        tx = (xx - x0)[None, :, None]
        a = low[y0][:, x0]
        b = low[y0][:, x0 + 1]
        c = low[y0 + 1][:, x0]
        d = low[y0 + 1][:, x0 + 1]
        img += (a * (1 - ty) * (1 - tx) + b * (1 - ty) * tx
                + c * ty * (1 - tx) + d * ty * tx) / (scale ** 0.5)
    img -= img.min()
    return (img / max(img.max(), 1e-6)).astype(np.float32)


def _sample_bilinear(img: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    h, w = img.shape[:2]
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 2)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 2)
    ty = (np.clip(ys, 0, h - 1) - y0)[..., None]
    tx = (np.clip(xs, 0, w - 1) - x0)[..., None]
    return (img[y0, x0] * (1 - ty) * (1 - tx) + img[y0, x0 + 1] * (1 - ty) * tx
            + img[y0 + 1, x0] * ty * (1 - tx) + img[y0 + 1, x0 + 1] * ty * tx)


@functools.lru_cache(maxsize=4096)
def _motion_frame(seq: int, t: int, h: int, w: int) -> np.ndarray:
    """Clean frame ``t`` of sequence ``seq``, (H, W, 3) float32.  Cached:
    it is pure in its arguments and costs tens of ms; the array is
    read-only (the datasets crop and copy it)."""
    rng = np.random.default_rng(seq * 7919)
    pad = 48
    bg = _texture(seq * 31 + 1, h + 2 * pad, w + 2 * pad)
    fg = _texture(seq * 31 + 2, h, w)
    # per-sequence velocities (px/frame): pan up to ±3, layers up to ±6
    pan = rng.uniform(-3, 3, 2)
    vel_fg = rng.uniform(-6, 6, 2)
    rot = rng.uniform(-0.01, 0.01)          # rad/frame
    zoom = 1.0 + rng.uniform(-0.004, 0.004)  # per frame
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float32),
                         np.arange(w, dtype=np.float32), indexing="ij")
    # background: camera pan
    out = _sample_bilinear(bg, yy + pad + pan[0] * t, xx + pad + pan[1] * t)
    # foreground patch: translate + rotate + zoom about its centre
    cy, cx = h * 0.5 + vel_fg[0] * t, w * 0.5 + vel_fg[1] * t
    ry, rx = h * 0.22, w * 0.22
    th = rot * t
    zs = zoom ** t
    ys = (np.cos(th) * (yy - cy) - np.sin(th) * (xx - cx)) / zs + h * 0.5
    xs = (np.sin(th) * (yy - cy) + np.cos(th) * (xx - cx)) / zs + w * 0.5
    inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    patch = _sample_bilinear(fg, ys, xs)
    out = np.where(inside[..., None], patch, out)
    out = np.clip(out, 0.0, 1.0).astype(np.float32)
    out.setflags(write=False)
    return out


def _degrade_realistic(img: np.ndarray, rng: np.random.Generator):
    """Two-pass box blur (approx. anisotropic gaussian), sensor-ish noise
    (signal-dependent), and 6-bit quantization banding."""
    out = img
    for k in (3, 3):
        pad = np.pad(out, ((1, 1), (1, 1), (0, 0)), mode="edge")
        out = sum(pad[dy:dy + img.shape[0], dx:dx + img.shape[1]]
                  for dy in range(k) for dx in range(k)) / (k * k)
    noise = rng.normal(0, 1, img.shape).astype(np.float32)
    out = out + noise * (0.004 + 0.02 * np.sqrt(np.maximum(out, 0)))
    out = np.round(out * 63) / 63.0  # mild banding
    return np.clip(out, 0.0, 1.0).astype(np.float32)


@functools.lru_cache(maxsize=4096)
def _lq_frame(seq: int, t: int, h: int, w: int, scale: int = 1) -> np.ndarray:
    """Degraded frame ``t`` of sequence ``seq`` (its noise drawn from a
    generator seeded by (seq, t)), MATLAB-bicubic x1/``scale`` when
    ``scale`` > 1.  Cached and read-only, as :func:`_motion_frame`."""
    lq = _degrade_realistic(_motion_frame(seq, t, h, w),
                            np.random.default_rng(seq * 1000 + t))
    if scale > 1:
        lq = np.clip(matlab_imresize_np(lq, 1.0 / scale), 0.0, 1.0)
    lq = lq.astype(np.float32)
    lq.setflags(write=False)
    return lq


class SyntheticMotionVSRDataset(SyntheticVSRDataset):
    """AllPair training set over the motion-rich generator: GT crops of
    ``GT_size`` and LQ crops of ``GT_size / scale`` at the same place.

    Raises a ValueError when ``GT_size`` is not a multiple of ``scale``:
    the LQ crop would not match the GT crop (the JAX class crops both
    anyway).
    """

    def __init__(self, opt: dict):
        super().__init__(opt)
        if self.gt_size % self.scale:
            raise ValueError(f"GT_size {self.gt_size} is not a multiple of "
                             f"scale {self.scale}")

    def get(self, index: int, rng: np.random.Generator) -> dict:
        key = self.keys[index]
        seq, frame = (int(v) for v in key.split("_"))
        half = self.n_frames // 2
        neighbors = [
            int(np.clip(frame + d, 0, self.frames_per_seq - 1))
            for d in range(-half, half + 1)
        ]
        s = self.scale
        gts = [_motion_frame(seq, t, self.frame_h, self.frame_w)
               for t in neighbors]
        lqs = [_lq_frame(seq, t, self.frame_h, self.frame_w, s)
               for t in neighbors]
        gt_size = self.gt_size
        # crop origin on the scale grid, so the LQ and GT crops correspond
        y = s * int(rng.integers(0, (self.frame_h - gt_size) // s + 1))
        x = s * int(rng.integers(0, (self.frame_w - gt_size) // s + 1))
        gts = [g[y:y + gt_size, x:x + gt_size] for g in gts]
        lqs = [v[y // s:(y + gt_size) // s, x // s:(x + gt_size) // s]
               for v in lqs]
        return {
            "LQs": np.stack(lqs).astype(np.float32),
            "GT": np.stack(gts).astype(np.float32),
            "key": key,
        }


class SyntheticMotionVideoTestDataset(SyntheticVideoTestDataset):
    """Eval clips over the motion-rich generator, sequences from
    ``seq_base`` (100: disjoint from the training sequences); LQ at
    1/``scale``, GT at full size."""

    SEQ_BASE = 100

    def _clip(self, s: int, h: int, w: int, opt: dict):
        scale = opt.get("scale") or 1
        frames = range(self.frames_per_seq)
        return (np.stack([_motion_frame(s, t, h, w) for t in frames]),
                np.stack([_lq_frame(s, t, h, w, scale) for t in frames]))
