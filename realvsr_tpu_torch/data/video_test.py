"""Sliding-window evaluation dataset (the reference's
``codes/data/VideoTestDataset.py``); a copy of
``realvsr_tpu/data/video_test.py`` on the port's image IO.  Caches whole
sequences in RAM and serves one centre frame per index with an
``index_generation`` window."""
from __future__ import annotations

import glob
import os.path as osp

from realvsr_tpu_torch.data.imageio import read_img_seq
from realvsr_tpu_torch.utils.indexing import index_generation


class VideoTestDataset:
    """Vid4 / REDS4 / RealVSR-style test folders.

    Returns per item: LQs (T, H, W, C), GT (H, W, C), folder, idx string
    'i/max', border flag (VideoTestDataset.py:60-81).
    """

    def __init__(self, opt: dict):
        self.opt = opt
        self.n_frames = opt["N_frames"]
        self.padding = opt.get("padding") or "replicate"
        self.cache_data = bool(opt.get("cache_data", True))
        self.gt_root, self.lq_root = opt["dataroot_GT"], opt["dataroot_LQ"]
        self.color = opt.get("color")
        if not self.cache_data:
            raise ValueError("Currently only support cache_data=True.")

        self.data_info = {"folder": [], "idx": [], "border": []}
        self.imgs_lq, self.imgs_gt = {}, {}
        subfolders_lq = sorted(glob.glob(osp.join(self.lq_root, "*")))
        subfolders_gt = sorted(glob.glob(osp.join(self.gt_root, "*")))
        for sub_lq, sub_gt in zip(subfolders_lq, subfolders_gt):
            name = osp.basename(sub_lq)
            max_idx = len(sorted(glob.glob(osp.join(sub_lq, "*"))))
            self.data_info["folder"].extend([name] * max_idx)
            self.data_info["idx"].extend(f"{i}/{max_idx}"
                                         for i in range(max_idx))
            border_l = [0] * max_idx
            for i in range(self.n_frames // 2):
                border_l[i] = 1
                border_l[max_idx - i - 1] = 1
            self.data_info["border"].extend(border_l)
            self.imgs_lq[name] = read_img_seq(sub_lq, color=self.color)
            self.imgs_gt[name] = read_img_seq(sub_gt, color=self.color)

    def __len__(self) -> int:
        return len(self.data_info["folder"])

    def __getitem__(self, index: int) -> dict:
        folder = self.data_info["folder"][index]
        idx, max_idx = map(int, self.data_info["idx"][index].split("/"))
        select_idx = index_generation(idx, max_idx, self.n_frames,
                                      padding=self.padding)
        return {
            "LQs": self.imgs_lq[folder][select_idx],
            "GT": self.imgs_gt[folder][idx],
            "folder": folder,
            "idx": self.data_info["idx"][index],
            "border": self.data_info["border"][index],
        }
