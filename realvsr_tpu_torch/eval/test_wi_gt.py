"""Full-reference evaluation (the reference ``codes/test_RealVSR_wi_GT.py``).

Emits the same per-frame / per-folder / total PSNR+SSIM table with the
centre/border breakdown as ``realvsr_tpu/eval/test_wi_gt.py``, so numbers
are directly comparable with the reference's logs.
"""
from __future__ import annotations

import glob
import logging
import os.path as osp
from functools import partial

import numpy as np

from realvsr_tpu_torch.data.imageio import read_img, read_img_seq, write_img
from realvsr_tpu_torch.eval.sliding_window import (
    make_forward, sliding_window_infer)
from realvsr_tpu_torch.ops.color import ycbcr2bgr_np
from realvsr_tpu_torch.ops.metrics import calculate_psnr_np, calculate_ssim_np

logger = logging.getLogger("base")


def evaluate_wi_gt(model, params, lq_root: str, gt_root: str, n_frames: int,
                   color: str = "YCbCr", padding: str = "replicate",
                   crop_border: int = 0, flip_test: bool = False,
                   save_folder: str | None = None) -> dict:
    """Evaluate over all sequence subfolders; returns the summary dict.
    ``params``: a state dict to load into ``model``, or None.  Restores
    through the sliding window (:func:`restore_wi_gt` takes the other
    restores)."""
    restore = partial(sliding_window_infer, make_forward(model, params),
                      n_frames=n_frames, padding=padding, flip_test=flip_test,
                      device=next(model.parameters()).device)
    return restore_wi_gt(restore, lq_root, gt_root, n_frames, color,
                         crop_border, save_folder)


def restore_wi_gt(restore, lq_root: str, gt_root: str, n_frames: int,
                  color: str = "YCbCr", crop_border: int = 0,
                  save_folder: str | None = None) -> dict:
    """:func:`evaluate_wi_gt` with the restore given: ``restore(frames)``
    yields (frame index, float32 numpy output) over a (T, H, W, C) sequence
    (the sliding window, its tiles or a stream; the test CLIs'
    ``tools/_cli.py::restorer``)."""
    subfolders = sorted(glob.glob(osp.join(lq_root, "*")))
    border_frame = n_frames // 2

    names, psnr_l, psnr_c_l, psnr_b_l = [], [], [], []
    ssim_l, ssim_c_l, ssim_b_l = [], [], []

    for subfolder in subfolders:
        name = osp.basename(subfolder)
        names.append(name)
        imgs = read_img_seq(subfolder, color=color)
        gt_paths = sorted(glob.glob(osp.join(gt_root, name, "*")))
        img_gt_l = []
        for p in gt_paths:
            g = read_img(p)
            if color == "YCbCr":
                g = g[:, :, ::-1]  # reverse channels (test_RealVSR_wi_GT.py:104)
            img_gt_l.append(g)

        max_idx = imgs.shape[0]
        sums = dict(pc=0.0, pb=0.0, sc=0.0, sb=0.0)
        n_center = n_border = 0

        for idx, out in restore(imgs):
            if save_folder:
                bgr = np.clip(ycbcr2bgr_np(np.clip(out, 0, 1).astype(np.float64))
                              if color == "YCbCr" else out[..., ::-1], 0, 1)
                write_img(osp.join(save_folder, name, f"{idx:05d}.png"), bgr)

            gt = np.squeeze(img_gt_l[idx])
            o = out
            if crop_border:
                o = o[crop_border:-crop_border, crop_border:-crop_border]
                gt = gt[crop_border:-crop_border, crop_border:-crop_border]
            o8 = (np.clip(o, 0, 1) * 255.0).round().astype(np.uint8)
            g8 = (np.clip(gt, 0, 1) * 255.0).round().astype(np.uint8)
            if color == "YCbCr":
                # Y-channel metrics (test_RealVSR_wi_GT.py:142-143)
                psnr = calculate_psnr_np(o8[:, :, 0], g8[:, :, 0])
                ssim = calculate_ssim_np(o8[:, :, 0], g8[:, :, 0])
            else:
                psnr = calculate_psnr_np(o8.astype(np.float64),
                                         g8.astype(np.float64))
                ssim = calculate_ssim_np(o8, g8)
            logger.info(f"{idx + 1:3d} - {idx:05d}\tPSNR: {psnr:.2f} dB "
                        f"\tSSIM: {ssim:.4f}")
            if border_frame <= idx < max_idx - border_frame:
                sums["pc"] += psnr; sums["sc"] += ssim; n_center += 1
            else:
                sums["pb"] += psnr; sums["sb"] += ssim; n_border += 1

        n_all = n_center + n_border
        avg_psnr = (sums["pc"] + sums["pb"]) / n_all
        avg_ssim = (sums["sc"] + sums["sb"]) / n_all
        avg_psnr_c = sums["pc"] / max(n_center, 1)
        avg_ssim_c = sums["sc"] / max(n_center, 1)
        avg_psnr_b = 0 if n_border == 0 else sums["pb"] / n_border
        avg_ssim_b = 0 if n_border == 0 else sums["sb"] / n_border
        psnr_l.append(avg_psnr); psnr_c_l.append(avg_psnr_c); psnr_b_l.append(avg_psnr_b)
        ssim_l.append(avg_ssim); ssim_c_l.append(avg_ssim_c); ssim_b_l.append(avg_ssim_b)

        logger.info(
            f"Folder {name} - Average PSNR: {avg_psnr:.2f} dB for {n_all} "
            f"frames; Center PSNR: {avg_psnr_c:.2f} dB for {n_center} frames; "
            f"Border PSNR: {avg_psnr_b:.2f} dB for {n_border} frames.")
        logger.info(
            f"Folder {name} - Average SSIM: {avg_ssim:.4f} for {n_all} "
            f"frames; Center SSIM: {avg_ssim_c:.4f} for {n_center} frames; "
            f"Border SSIM: {avg_ssim_b:.4f} for {n_border} frames.")

    logger.info("################ Tidy Outputs ################")
    for name, p, pc, pb in zip(names, psnr_l, psnr_c_l, psnr_b_l):
        logger.info(f"Folder {name} - Average PSNR: {p:.2f} dB. "
                    f"Center PSNR: {pc:.2f} dB. Border PSNR: {pb:.2f} dB.")
    for name, s, sc, sb in zip(names, ssim_l, ssim_c_l, ssim_b_l):
        logger.info(f"Folder {name} - Average SSIM: {s:.4f}. "
                    f"Center SSIM: {sc:.4f}. Border SSIM: {sb:.4f}.")
    logger.info("################ Final Results ################")
    summary = {
        "psnr": float(np.mean(psnr_l)),
        "psnr_center": float(np.mean(psnr_c_l)),
        "psnr_border": float(np.mean(psnr_b_l)),
        "ssim": float(np.mean(ssim_l)),
        "ssim_center": float(np.mean(ssim_c_l)),
        "ssim_border": float(np.mean(ssim_b_l)),
        "n_clips": len(names),
    }
    logger.info(
        f"Total Average PSNR: {summary['psnr']:.2f} dB for "
        f"{summary['n_clips']} clips. Center PSNR: "
        f"{summary['psnr_center']:.2f} dB. Border PSNR: "
        f"{summary['psnr_border']:.2f} dB.")
    logger.info(
        f"Total Average SSIM: {summary['ssim']:.4f} for "
        f"{summary['n_clips']} clips. Center SSIM: "
        f"{summary['ssim_center']:.4f}. Border SSIM: "
        f"{summary['ssim_border']:.4f}.")
    return summary
