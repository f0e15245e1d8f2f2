"""RealVSR training datasets (the reference's ``codes/data/RealVSR_dataset.py``).

Counterparts of ``realvsr_tpu/data/realvsr.py``, with the same random draws
in the same order, so an item equals the JAX package's for the same
``rng``.  Host-side map-style datasets: each ``get`` decodes a temporal
window of frames (PNG folders, or raw uint8 buffers in an LMDB environment
read by :mod:`~realvsr_tpu_torch.data.lmdb_lite`), applies the reference's
window / crop / flip policy with an explicit numpy Generator (no global
RNG), and returns float32 NHWC arrays.  Batching and sampling live in
``data/loader.py``.

Key format ``SSS_FFFFF``: 500 sequences x 50 frames (prepare_data.py:61-67);
the 50 held-out test sequences are removed (RealVSR_dataset.py:51-58, or the
``remove_list`` pickle, :216-221).
"""
from __future__ import annotations

import os.path as osp
import pickle

import numpy as np

from realvsr_tpu_torch.data import lmdb_lite
from realvsr_tpu_torch.data.imageio import (channel_convert, read_img,
                                            read_img_lmdb)

# the hard-coded test split of RealVSRDataset (RealVSR_dataset.py:51-58)
TEST_SEQUENCES = [
    "008", "026", "029", "031", "042", "055", "058", "077", "105", "113",
    "132", "135", "146", "155", "161", "167", "173", "175", "180", "181",
    "189", "194", "195", "226", "232", "237", "241", "242", "247", "256",
    "268", "275", "293", "309", "358", "371", "372", "379", "383", "401",
    "409", "413", "426", "438", "448", "471", "478", "484", "490", "498",
]


def _augment_images(imgs: list[np.ndarray], hflip: bool, vflip: bool,
                    rot90: bool) -> list[np.ndarray]:
    """Flip / rotate augmentation (data/util.py:261-276), as views."""

    def _aug(img):
        if hflip:
            img = img[:, ::-1, :]
        if vflip:
            img = img[::-1, :, :]
        if rot90:
            img = img.transpose(1, 0, 2)
        return img

    return [_aug(v) for v in imgs]


def train_crop_flip(opt: dict, rng: np.random.Generator, lqs: list,
                    gts: list, gt_size: int, lr_input: bool, scale: int):
    """The training crop (GT_size, or GT_size / scale on the LQ side when
    the LQ is smaller) and the flips / rotation of the RealVSR and Vimeo90K
    datasets, drawn from ``rng`` in the reference's order."""
    h, w = lqs[0].shape[:2]
    if lr_input:
        lq_size = gt_size // scale
        rh = int(rng.integers(0, max(0, h - lq_size) + 1))
        rw = int(rng.integers(0, max(0, w - lq_size) + 1))
        lqs = [v[rh:rh + lq_size, rw:rw + lq_size] for v in lqs]
        rh_hr, rw_hr = rh * scale, rw * scale
        gts = [v[rh_hr:rh_hr + gt_size, rw_hr:rw_hr + gt_size] for v in gts]
    else:
        rh = int(rng.integers(0, max(0, h - gt_size) + 1))
        rw = int(rng.integers(0, max(0, w - gt_size) + 1))
        lqs = [v[rh:rh + gt_size, rw:rw + gt_size] for v in lqs]
        gts = [v[rh:rh + gt_size, rw:rw + gt_size] for v in gts]
    hflip = bool(opt.get("use_flip")) and rng.random() < 0.5
    vflip = bool(opt.get("use_rot")) and rng.random() < 0.5
    rot90 = bool(opt.get("use_rot")) and rng.random() < 0.5
    both = _augment_images(lqs + gts, hflip, vflip, rot90)
    return both[:len(lqs)], both[len(lqs):]


def stack_item(lqs: list, gts: list, all_pair: bool, key: str) -> dict:
    """The item: LQ frames (T, H, W, C) and the GT frames (AllPair) or the
    centre GT (H, W, C), BGR flipped to RGB order, contiguous float32."""
    lq_stack = np.stack(lqs, axis=0)
    gt_stack = np.stack(gts, axis=0)
    if lq_stack.shape[-1] == 3:  # BGR → RGB channel order
        lq_stack = lq_stack[..., ::-1]
        gt_stack = gt_stack[..., ::-1]
    return {
        "LQs": np.ascontiguousarray(lq_stack, dtype=np.float32),
        "GT": np.ascontiguousarray(gt_stack if all_pair else gt_stack[0],
                                   dtype=np.float32),
        "key": key,
    }


class RealVSRDataset:
    """N-frame window around a centre key; GT = the centre frame only."""

    all_pair = False

    def __init__(self, opt: dict):
        self.opt = opt
        self.interval_list = opt["interval_list"] or [1]
        self.random_reverse = bool(opt["random_reverse"])
        self.border_mode = bool(opt["border_mode"])
        self.n_frames = opt["N_frames"]
        self.half_n = self.n_frames // 2
        self.gt_root, self.lq_root = opt["dataroot_GT"], opt["dataroot_LQ"]
        self.gt_size = opt["GT_size"]
        self.lq_size = opt.get("LQ_size") or self.gt_size
        self.lr_input = self.gt_size != self.lq_size
        self.scale = opt.get("scale") or 1
        self.color = opt.get("color")
        self.is_train = opt.get("phase") == "train"
        self.max_frame = int(opt.get("max_frame_idx") or 49)
        # the lmdb backend (RealVSR_dataset.py:60-74): roots ending in
        # 'lmdb' hold raw uint8 buffers keyed SSS_FFFFF; opened on first use
        self.data_type = opt.get("data_type") or (
            "lmdb" if str(self.gt_root).endswith("lmdb") else "img")
        self.gt_env = self.lq_env = None
        # the fixed RealVSR frame geometry (C, H, W), RealVSR_dataset.py:121
        self.img_shape = tuple(opt.get("img_shape") or (3, 1024, 512))

        if not opt.get("cache_keys"):
            raise ValueError("cache_keys pickle is required for RealVSR data")
        with open(opt["cache_keys"], "rb") as f:
            keys = pickle.load(f)["keys"]
        if opt.get("remove_list"):
            with open(opt["remove_list"], "rb") as f:
                remove = set(pickle.load(f))
        else:
            remove = set(TEST_SEQUENCES)
        self.keys = [k for k in keys if k.split("_")[0] not in remove]
        if not self.keys:
            raise ValueError("Error: GT path is empty.")

    def __len__(self) -> int:
        return len(self.keys)

    def _neighbor_list(self, center: int, rng: np.random.Generator) -> list:
        """The temporal window policy (RealVSR_dataset.py:82-118)."""
        interval = int(rng.choice(self.interval_list))
        n = self.n_frames
        if self.border_mode:
            direction = 1
            if self.random_reverse and rng.random() < 0.5:
                direction = int(rng.choice([0, 1]))
            if center + interval * (n - 1) > self.max_frame:
                direction = 0
            elif center - interval * (n - 1) < 0:
                direction = 1
            if direction == 1:
                return list(range(center, center + interval * n, interval))
            return list(range(center, center - interval * n, -interval))
        while (center + self.half_n * interval > self.max_frame or
               center - self.half_n * interval < 0):
            center = int(rng.integers(0, self.max_frame + 1))
        neighbors = list(range(center - self.half_n * interval,
                               center + self.half_n * interval + 1, interval))
        if self.random_reverse and rng.random() < 0.5:
            neighbors.reverse()
        return neighbors

    def _read(self, root: str, seq: str, frame: int) -> np.ndarray:
        if self.data_type == "lmdb":
            if self.gt_env is None:
                self.gt_env = lmdb_lite.open(self.gt_root, readonly=True)
                self.lq_env = lmdb_lite.open(self.lq_root, readonly=True)
            env = self.gt_env if root == self.gt_root else self.lq_env
            img = read_img_lmdb(env, f"{seq}_{frame:05d}", self.img_shape)
        else:
            img = read_img(osp.join(root, seq, f"{frame:05d}.png"))
        if self.color:
            img = channel_convert(img.shape[2], self.color, [img])[0]
        return img

    def get(self, index: int, rng: np.random.Generator) -> dict:
        key = self.keys[index]
        seq, frame = key.split("_")
        neighbors = self._neighbor_list(int(frame), rng)
        lqs = [self._read(self.lq_root, seq, v) for v in neighbors]
        center = neighbors[0] if self.border_mode else neighbors[self.half_n]
        gts = [self._read(self.gt_root, seq, v)
               for v in (neighbors if self.all_pair else [center])]
        if self.is_train:
            lqs, gts = train_crop_flip(self.opt, rng, lqs, gts, self.gt_size,
                                       self.lr_input, self.scale)
        return stack_item(lqs, gts, self.all_pair, key)

    def __getitem__(self, index: int) -> dict:
        # map-style access with a per-index seed (deterministic)
        return self.get(index, np.random.default_rng(index))


class RealVSRAllPairDataset(RealVSRDataset):
    """GT for all N frames (RealVSR_dataset.py:180-346), as the AllPair
    wrappers and cutblur need."""

    all_pair = True
