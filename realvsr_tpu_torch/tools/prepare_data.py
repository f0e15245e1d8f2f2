"""Offline data preparation (the reference's ``codes/scripts/
prepare_data.py``): RGB -> YCbCr conversion of RealVSR / Vimeo90K trees,
key pickles, MATLAB-bicubic LR generation and LMDB packing.

    python -m realvsr_tpu_torch.tools.prepare_data realvsr-ycbcr  <src> <dst> [--only-y]
    python -m realvsr_tpu_torch.tools.prepare_data vimeo90k-ycbcr <src> <dst>
    python -m realvsr_tpu_torch.tools.prepare_data realvsr-keys   <save.pkl>
    python -m realvsr_tpu_torch.tools.prepare_data vimeo90k-lr    <src> <dst> --scale 2
    python -m realvsr_tpu_torch.tools.prepare_data create-lmdb    <png_root> <dst.lmdb> \\
        [--sharpen-gt] [--seed S]

Counterpart of ``tools/prepare_data.py`` on the port's own modules
(``ops/color.py``, ``ops/resize.py``, ``data/lmdb_lite.py``,
``data/sharpen.py``); the files it writes are the JAX tool's, byte for
byte.  Host-only: it runs no model.
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import pickle
import zlib

import cv2
import numpy as np

from realvsr_tpu_torch.ops.color import bgr2ycbcr_np
from realvsr_tpu_torch.ops.resize import matlab_imresize_np


def _convert_img(src_path, dst_path, only_y):
    dst = bgr2ycbcr_np(cv2.imread(src_path), only_y=only_y)
    os.makedirs(osp.dirname(dst_path), exist_ok=True)
    # channel-reverse on write so cv2's BGR storage round-trips (Y, Cb, Cr)
    cv2.imwrite(dst_path, dst[:, :, ::-1] if dst.ndim == 3 else dst)


def _vimeo_pngs(src_root):
    """(<a>/<b>/<name>, path) of every PNG of a Vimeo90K sequence tree."""
    for p in sorted(glob.glob(osp.join(src_root, "*", "*", "*.png"))):
        yield osp.join(*p.split(os.sep)[-3:]), p


def realvsr_ycbcr(src_root, dst_root, only_y=False):
    for seq_path in sorted(glob.glob(osp.join(src_root, "*"))):
        seq = osp.basename(seq_path)
        print(f"Processing {seq}")
        for p in sorted(glob.glob(osp.join(seq_path, "*.png"))):
            _convert_img(p, osp.join(dst_root, seq, osp.basename(p)), only_y)


def vimeo90k_ycbcr(src_root, dst_root):
    for rel, p in _vimeo_pngs(src_root):
        _convert_img(p, osp.join(dst_root, rel), only_y=False)


def realvsr_keys(save_path, num_seqs=500, frames=50):
    keys = [f"{s:03d}_{f:05d}" for s in range(num_seqs) for f in range(frames)]
    with open(save_path, "wb") as f:
        pickle.dump({"keys": keys}, f)
    print(f"wrote {len(keys)} keys to {save_path}")


def vimeo90k_lr(src_root, dst_root, scale=2):
    """Bicubic down-up LR generation (generate_LR_BI_Vimeo90K.m): down by
    1/scale then back up, MATLAB-exact bicubic."""
    for rel, p in _vimeo_pngs(src_root):
        img = cv2.imread(p).astype(np.float64) / 255.0
        lr_up = matlab_imresize_np(matlab_imresize_np(img, 1.0 / scale),
                                   float(scale))
        out = np.clip(lr_up * 255.0, 0, 255).round().astype(np.uint8)
        dst = osp.join(dst_root, rel)
        os.makedirs(osp.dirname(dst), exist_ok=True)
        cv2.imwrite(dst, out)


def create_lmdb(png_root, dst_path, sharpen=False, seed=0):
    """Pack <png_root>/<seq>/<frame>.png into an LMDB of raw uint8 HWC
    buffers keyed ``SSS_FFFFF`` (data/util.py:76-84); ``sharpen`` applies
    the GT UnsharpMask pipeline (data/util.py:435-480) with a per-key rng
    seeded from the key's CRC32 and ``seed``."""
    from realvsr_tpu_torch.data.lmdb_lite import write_lmdb
    from realvsr_tpu_torch.data.sharpen import sharpen_gt

    def items():
        for seq_path in sorted(glob.glob(osp.join(png_root, "*"))):
            if not osp.isdir(seq_path):
                continue
            seq = osp.basename(seq_path)
            print(f"Packing {seq}")
            for p in sorted(glob.glob(osp.join(seq_path, "*.png"))):
                key = f"{seq}_{int(osp.splitext(osp.basename(p))[0]):05d}"
                img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
                if sharpen:
                    rng = np.random.default_rng(
                        (zlib.crc32(key.encode("ascii")) ^ seed) & 0x7FFFFFFF)
                    img = sharpen_gt(img, rng)
                yield key.encode("ascii"), np.ascontiguousarray(img).tobytes()

    write_lmdb(dst_path, items())
    print(f"wrote {dst_path}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cmd", choices=["realvsr-ycbcr", "vimeo90k-ycbcr",
                                        "realvsr-keys", "vimeo90k-lr",
                                        "create-lmdb"])
    parser.add_argument("paths", nargs="+")
    parser.add_argument("--only-y", action="store_true")
    parser.add_argument("--scale", type=int, default=2)
    parser.add_argument("--sharpen-gt", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    p = args.paths
    if args.cmd == "realvsr-ycbcr":
        realvsr_ycbcr(p[0], p[1], args.only_y)
    elif args.cmd == "vimeo90k-ycbcr":
        vimeo90k_ycbcr(p[0], p[1])
    elif args.cmd == "realvsr-keys":
        realvsr_keys(p[0])
    elif args.cmd == "vimeo90k-lr":
        vimeo90k_lr(p[0], p[1], args.scale)
    else:
        create_lmdb(p[0], p[1], args.sharpen_gt, args.seed)


if __name__ == "__main__":
    main()
