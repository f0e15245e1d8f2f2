"""No-reference inference (the reference ``codes/test_RealVSR_wo_GT.py``):
sliding-window restore every sequence and log per-frame latency ("Average
inference time"), the reference's headline speed metric.  Same signature and
log lines as ``realvsr_tpu/eval/test_wo_gt.py``."""
from __future__ import annotations

import glob
import logging
import os.path as osp
import time
from functools import partial

import numpy as np

from realvsr_tpu_torch.data.imageio import read_img_seq, write_img
from realvsr_tpu_torch.eval.sliding_window import (
    make_forward, sliding_window_infer)
from realvsr_tpu_torch.ops.color import ycbcr2bgr_np

logger = logging.getLogger("base")


def evaluate_wo_gt(model, params, lq_root: str, n_frames: int,
                   color: str = "YCbCr", padding: str = "replicate",
                   flip_test: bool = False,
                   save_folder: str | None = None) -> dict:
    """``params``: a state dict to load into ``model``, or None.  Runs on
    the device that holds the model's weights, through the sliding window
    (:func:`restore_wo_gt` takes the other restores)."""
    restore = partial(sliding_window_infer, make_forward(model, params),
                      n_frames=n_frames, padding=padding, flip_test=flip_test,
                      device=next(model.parameters()).device)
    return restore_wo_gt(restore, lq_root, color, save_folder)


def restore_wo_gt(restore, lq_root: str, color: str = "YCbCr",
                  save_folder: str | None = None) -> dict:
    """:func:`evaluate_wo_gt` with the restore given: ``restore(frames)``
    yields (frame index, float32 numpy output) over a (T, H, W, C) sequence
    (the sliding window, its tiles or a stream; the test CLIs'
    ``tools/_cli.py::restorer``)."""
    subfolders = sorted(glob.glob(osp.join(lq_root, "*")))
    total_time, total_frames = 0.0, 0

    for subfolder in subfolders:
        name = osp.basename(subfolder)
        imgs = read_img_seq(subfolder, color=color)
        t0 = time.time()
        for idx, out in restore(imgs):
            if save_folder:
                bgr = np.clip(
                    ycbcr2bgr_np(np.clip(out, 0, 1).astype(np.float64))
                    if color == "YCbCr" else out[..., ::-1], 0, 1)
                write_img(osp.join(save_folder, name, f"{idx:05d}.png"), bgr)
        dt = time.time() - t0
        total_time += dt
        total_frames += imgs.shape[0]
        logger.info(f"Folder {name}: {imgs.shape[0]} frames in {dt:.3f}s "
                    f"({dt / imgs.shape[0]:.4f} s/frame)")

    avg = total_time / max(total_frames, 1)
    logger.info(f"Average inference time: {avg:.6f} s/frame "
                f"({1.0 / max(avg, 1e-9):.2f} frames/s)")
    return {"s_per_frame": avg, "frames_per_s": 1.0 / max(avg, 1e-9),
            "n_frames": total_frames}
