"""Batch augmentations on the device (the reference's
``codes/data/augments_video_allpair.py``).

Counterpart of ``realvsr_tpu/data/augments.py``: pure functions over
(B, T, H, W, C) video batches, drawing from an explicit ``torch.Generator``
on the batch's device.  As there, CutBlur's box is a mask built from index
comparisons, and every random decision stays on the device: each branch is
computed and :func:`apply_augment` selects one with ``torch.where``, so no
step waits for the device to pick a branch (the branches are a few
elementwise passes over the batch).  Under a process group every rank
holds the same generator state and draws for the global batch, keeping
its own rows, so the ranks' batches are augmented as JAX augments the
global one.
"""
from __future__ import annotations

from functools import partial
from typing import Sequence

import torch

from realvsr_tpu_torch.parallel.mesh import rank, world_size


def _uniform(gen: torch.Generator, like: torch.Tensor, shape=(), lo=0.0,
             hi=1.0) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=like.device,
                   dtype=torch.float32)
    return (lo + (hi - lo) * u).to(like.dtype)


def _blend(gen, gt, lq, prob: float, alpha: float):
    """Blend with a random solid colour (augments_video_allpair.py:38-50)."""
    gate = (_uniform(gen, gt).float() < prob) & (alpha > 0)
    # one colour per example of the global batch; this rank takes its rows
    b, world = gt.shape[0], world_size()
    c = _uniform(gen, gt, (b * world, gt.shape[1], 1, 1, gt.shape[-1]))
    c = c[rank() * b:(rank() + 1) * b]
    v = _uniform(gen, gt, (), alpha, 1.0)
    gt_a, lq_a = v * gt + (1 - v) * c, v * lq + (1 - v) * c
    return torch.where(gate, gt_a, gt), torch.where(gate, lq_a, lq)


def _cutblur(gen, gt, lq, prob: float, alpha: float):
    """LQ <-> GT patch swap (augments_video_allpair.py:53-75), x1 scale:
    GT and LQ of one size, or a ValueError (the reference raises too; the
    JAX package fails to broadcast)."""
    if gt.shape != lq.shape:
        raise ValueError(f"cutblur takes GT and LQ of one size, got "
                         f"{tuple(gt.shape)} and {tuple(lq.shape)}")
    dev = gt.device
    h, w = gt.shape[-3], gt.shape[-2]
    gate = (torch.rand((), generator=gen, device=dev) < prob) & (alpha > 0)
    # box of floor(h*ratio) x floor(w*ratio), ratio ~ N(alpha, 0.01) in
    # [0, 1], at a uniform position
    ratio = (torch.randn((), generator=gen, device=dev) * 0.01
             + alpha).clamp(0.0, 1.0)
    ch, cw = torch.floor(h * ratio), torch.floor(w * ratio)
    cy = torch.floor(torch.rand((), generator=gen, device=dev) * (h - ch + 1))
    cx = torch.floor(torch.rand((), generator=gen, device=dev) * (w - cw + 1))
    iy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
    ix = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
    box = ((iy >= cy) & (iy < cy + ch) & (ix >= cx) & (ix < cx + cw))
    box = box[None, None, :, :, None]
    inside = torch.rand((), generator=gen, device=dev) > 0.5
    # inside: paste the GT patch into LQ; outside: keep the LQ patch, GT
    # elsewhere
    lq_a = torch.where(inside, torch.where(box, gt, lq),
                       torch.where(box, lq, gt))
    return gt, torch.where(gate, lq_a, lq)


def _rgb(gen, gt, lq, prob: float):
    """Random channel permutation (augments_video_allpair.py:78-86)."""
    gate = torch.rand((), generator=gen, device=gt.device) < prob
    perm = torch.randperm(gt.shape[-1], generator=gen, device=gt.device)
    return (torch.where(gate, gt[..., perm], gt),
            torch.where(gate, lq[..., perm], lq))


def apply_augment(gen: torch.Generator, gt: torch.Tensor, lq: torch.Tensor,
                  augs: Sequence[str], probs: Sequence[float],
                  alphas: Sequence[float],
                  mix_p: Sequence[float] | None = None):
    """Pick one augmentation by ``mix_p`` and apply it to (GT, LQ) batches
    (GT first, as the reference passes im1=GT, im2=LQ).  Returns
    (gt_aug, lq_aug)."""
    branches = []
    for name, prob, alpha in zip(augs, probs, alphas):
        prob, alpha = float(prob), float(alpha)
        if name == "none":
            branches.append(lambda g, a, b: (a, b))
        elif name == "blend":
            branches.append(partial(_blend, prob=prob, alpha=alpha))
        elif name == "cutblur":
            branches.append(partial(_cutblur, prob=prob, alpha=alpha))
        elif name == "rgb":
            branches.append(partial(_rgb, prob=prob))
        else:
            raise ValueError(f"{name} is not a valid augmentation.")
    p = torch.tensor([1.0] * len(augs) if mix_p is None
                     else [float(v) for v in mix_p], device=gt.device)
    idx = torch.multinomial(p, 1, generator=gen)[0]
    out_gt, out_lq = gt, lq
    for i, branch in enumerate(branches):
        gt_i, lq_i = branch(gen, gt, lq)
        out_gt = torch.where(idx == i, gt_i, out_gt)
        out_lq = torch.where(idx == i, lq_i, out_lq)
    return out_gt, out_lq
