"""Synthetic video datasets for tests, debug configs and the chip smoke run.

A copy of the drifting-sinusoid half of ``realvsr_tpu/data/synthetic.py``
(numpy only): the GT is a smooth moving pattern, the LQ a blurred and noisy
copy, both deterministic in (sequence, frame).  Items follow the RealVSR
datasets' schema, so the train and eval stacks run without the dataset.
"""
from __future__ import annotations

import numpy as np

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
    """Eval dataset with the VideoTestDataset item schema."""

    def __init__(self, opt: dict):
        self.n_frames = opt.get("N_frames") or 3
        self.padding = opt.get("padding") or "replicate"
        self.num_seqs = opt.get("num_seqs") or 2
        self.frames_per_seq = opt.get("frames_per_seq") or 6
        h = opt.get("frame_h") or 64
        w = opt.get("frame_w") or 64
        self.imgs_gt, self.imgs_lq = {}, {}
        self.entries = []
        for s in range(self.num_seqs):
            name = f"{s:03d}"
            gts = np.stack([_frame(s, t, h, w)
                            for t in range(self.frames_per_seq)])
            lqs = np.stack([
                _degrade(gts[t], np.random.default_rng(s * 1000 + t))
                for t in range(self.frames_per_seq)
            ])
            self.imgs_gt[name] = gts
            self.imgs_lq[name] = lqs
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
