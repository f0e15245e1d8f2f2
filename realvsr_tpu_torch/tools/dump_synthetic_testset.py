"""Dump held-out motion-synthetic sequences to GT / LQ PNG folders.

    python -m realvsr_tpu_torch.tools.dump_synthetic_testset \\
        --out datasets/synthetic_motion_test --num_seqs 4 --frames 20 \\
        --height 256 --width 256

Counterpart of ``tools/dump_synthetic_testset.py`` on the port's
``data/synthetic.py``: sequences ``seq_base`` .. (100 by default, disjoint
from the training ids) in the per-sequence folder layout that the test
command lines read (``<out>/GT/<seq>/<t>.png``, ``<out>/LQ/...``), planes
written reversed (cv2's BGR order) so reading them back gives the
generator's (Y, Cb, Cr)-role channels; the PNGs are the JAX tool's.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp

import cv2
import numpy as np

from realvsr_tpu_torch.data.synthetic import _degrade_realistic, _motion_frame


def dump(out: str, seq_base: int = 100, num_seqs: int = 4, frames: int = 20,
         height: int = 256, width: int = 256) -> None:
    for s in range(seq_base, seq_base + num_seqs):
        name = f"{s:03d}"
        dirs = [osp.join(out, part, name) for part in ("GT", "LQ")]
        for d in dirs:
            os.makedirs(d, exist_ok=True)
        for t in range(frames):
            gt = _motion_frame(s, t, height, width)
            lq = _degrade_realistic(gt, np.random.default_rng(s * 1000 + t))
            for arr, d in zip((gt, lq), dirs):
                u8 = (np.clip(arr, 0.0, 1.0) * 255.0).round().astype(np.uint8)
                cv2.imwrite(osp.join(d, f"{t:05d}.png"), u8[:, :, ::-1])
        print(f"dumped {name}: {frames} frames ({height}x{width})", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seq_base", type=int, default=100)
    ap.add_argument("--num_seqs", type=int, default=4)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--width", type=int, default=256)
    a = ap.parse_args(argv)
    dump(a.out, a.seq_base, a.num_seqs, a.frames, a.height, a.width)


if __name__ == "__main__":
    main()
