"""Vimeo90K septuplet datasets (the reference's ``codes/data/Vimeo90K_dataset.py``).

Counterparts of ``realvsr_tpu/data/vimeo90k.py``, with the same random
draws in the same order.  Keys ``00001_0001``; files
``<root>/<a>/<b>/im{1..7}.png``; the LQ window is centred on im4
(``frame_list = i + (9 - N) // 2``), the GT is im4 (or every window frame
for the AllPair form).  The LR-input mode takes precomputed x``scale`` LQ.
"""
from __future__ import annotations

import os.path as osp
import pickle

import numpy as np

from realvsr_tpu_torch.data.imageio import channel_convert, read_img
from realvsr_tpu_torch.data.realvsr import stack_item, train_crop_flip


class Vimeo90KDataset:
    all_pair = False

    def __init__(self, opt: dict):
        self.opt = opt
        self.random_reverse = bool(opt["random_reverse"])
        self.gt_root, self.lq_root = opt["dataroot_GT"], opt["dataroot_LQ"]
        self.gt_size = opt["GT_size"]
        self.lq_size = opt.get("LQ_size") or self.gt_size
        self.lr_input = self.gt_size != self.lq_size
        self.scale = opt.get("scale") or 1
        self.color = opt.get("color")
        self.is_train = opt.get("phase") == "train"
        self.n_frames = opt["N_frames"]
        self.frame_list = [i + (9 - self.n_frames) // 2
                           for i in range(self.n_frames)]
        if not opt.get("cache_keys"):
            raise ValueError("cache_keys pickle is required for Vimeo90K data")
        with open(opt["cache_keys"], "rb") as f:
            self.keys = pickle.load(f)["keys"]
        if not self.keys:
            raise ValueError("Error: GT path is empty.")

    def __len__(self):
        return len(self.keys)

    def _read(self, root: str, name_a: str, name_b: str, v: int) -> np.ndarray:
        img = read_img(osp.join(root, name_a, name_b, f"im{v}.png"))
        if self.color:
            img = channel_convert(img.shape[2], self.color, [img])[0]
        return img

    def get(self, index: int, rng: np.random.Generator) -> dict:
        key = self.keys[index]
        name_a, name_b = key.split("_")
        frames = list(self.frame_list)
        if self.random_reverse and rng.random() < 0.5:
            frames.reverse()
        lqs = [self._read(self.lq_root, name_a, name_b, v) for v in frames]
        gts = [self._read(self.gt_root, name_a, name_b, v)
               for v in (frames if self.all_pair else [4])]
        if self.is_train:
            lqs, gts = train_crop_flip(self.opt, rng, lqs, gts, self.gt_size,
                                       self.lr_input, self.scale)
        return stack_item(lqs, gts, self.all_pair, key)

    def __getitem__(self, index: int) -> dict:
        return self.get(index, np.random.default_rng(index))


class Vimeo90KAllPairDataset(Vimeo90KDataset):
    all_pair = True
