"""RealVSR's YCbCr Split training step in plain PyTorch (NCHW): the batch
augmentation, the Split loss and Adam.

* Augmentation: the recipe's pick between "none" and CutBlur
  (``augments_video_allpair.py``), drawing from a ``torch.Generator`` on
  the batch's device in the order the port's ``data/augments.py`` draws
  (one multinomial pick, then CutBlur's gate, box ratio, position and
  direction), so one generator state gives both sides the same batch.
* Loss (``VideoSR_AllPair_model_YCbCr_Split.py``): on the centre frame,
  w_y x LapPyrLoss on Y (3-level Laplacian pyramid, the base level compared
  by 1 - SSIM with an 11-tap, sigma 1.5 window, VALID, C1 = 0.01^2, C2 =
  0.03^2; the other levels by Charbonnier, eps 1e-6 inside the root) plus
  w_c x the gradient-weighted L1 on CbCr ((1 + 4|dSx|)(1 + 4|dSy|)|x - y|,
  Sobel differences, zero padding).  The pyramid blurs with the 5x5
  binomial kernel / 256 under reflect padding, decimates by 2, and
  upsamples by zero-stuffing and blurring with 4x the kernel.
* Adam (betas from the recipe, eps 1e-8, bias-corrected) at the cosine
  schedule's rate of update t: eta_min + (lr - eta_min)(1 + cos(pi t /
  T)) / 2 in the first period.

Every loss term is a mean over the batch's pixels, so the batch can be
taken in blocks of rows whose losses, weighted by their share of the batch,
add up to the whole batch's (:func:`loss_and_grads`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import edvr

_BINOMIAL = torch.tensor(np.outer([1, 4, 6, 4, 1], [1, 4, 6, 4, 1]) / 256.0)
_SOBEL_X = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
_SOBEL_Y = _SOBEL_X.t().contiguous()


# ---- augmentation ------------------------------------------------------------
def _cutblur(gen, gt, lq, prob, alpha):
    dev = gt.device
    h, w = gt.shape[-3], gt.shape[-2]
    gate = (torch.rand((), generator=gen, device=dev) < prob) & (alpha > 0)
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
    lq_a = torch.where(inside, torch.where(box, gt, lq),
                       torch.where(box, lq, gt))
    return gt, torch.where(gate, lq_a, lq)


def augment(gen, gt, lq, aug: dict):
    """(gt, lq) after the recipe's augmentation; (B, T, H, W, C) tensors."""
    p = torch.tensor([float(v) for v in aug["mix_p"]], device=gt.device)
    pick = torch.multinomial(p, 1, generator=gen)[0]
    out_gt, out_lq = gt, lq
    for i, (name, prob, alpha) in enumerate(zip(aug["augs"], aug["probs"],
                                                aug["alphas"])):
        if name == "none":
            g, q = gt, lq
        elif name == "cutblur":
            g, q = _cutblur(gen, gt, lq, float(prob), float(alpha))
        else:
            raise NotImplementedError(f"augmentation {name!r}")
        out_gt = torch.where(pick == i, g, out_gt)
        out_lq = torch.where(pick == i, q, out_lq)
    return out_gt, out_lq


# ---- losses ------------------------------------------------------------------
def _blur(x, scale=1.0):
    c = x.shape[1]
    k = (_BINOMIAL * scale).to(x.dtype).to(x.device).expand(c, 1, 5, 5)
    return F.conv2d(F.pad(x, (2, 2, 2, 2), mode="reflect"), k, groups=c)


def _down(x):
    return x[:, :, ::2, ::2]


def _up(x):
    b, c, h, w = x.shape
    z = x.new_zeros(b, c, 2 * h, 2 * w)
    z[:, :, ::2, ::2] = x
    return _blur(z, 4.0)


def laplacian_pyramid(x, levels=3):
    pyr = []
    for _ in range(levels - 1):
        down = _down(_blur(x))
        pyr.append(x - _up(down))
        x = down
    return pyr + [x]


def charbonnier(x, y, eps=1e-6):
    d = x - y
    return torch.sqrt(d * d + eps).mean()


def ssim(x, y):
    """Per-image SSIM of NCHW batches in [0, 1] (VALID, 11 taps,
    sigma 1.5; no downsampling below 256 px), as (B,)."""
    f = max(1, round(min(x.shape[2], x.shape[3]) / 256))
    if f > 1:
        x, y = F.avg_pool2d(x, f), F.avg_pool2d(y, f)
    g = np.exp(-((np.arange(11) - 5.0) ** 2) / (2 * 1.5 ** 2))
    g = np.outer(g, g)
    win = torch.tensor(g / g.sum(), dtype=x.dtype, device=x.device)
    c = x.shape[1]
    win = win.expand(c, 1, 11, 11)

    def filt(t):
        return F.conv2d(t, win, groups=c)

    mu1, mu2 = filt(x), filt(y)
    s1 = filt(x * x) - mu1 ** 2
    s2 = filt(y * y) - mu2 ** 2
    s12 = filt(x * y) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) / (mu1 ** 2 + mu2 ** 2 + c1)
         * (2 * s12 + c2) / (s1 + s2 + c2))
    return m.mean(dim=(1, 2, 3))


def lap_pyr_loss(x, y):
    px, py = laplacian_pyramid(x), laplacian_pyramid(y)
    loss = 1.0 - ssim(px[-1], py[-1]).mean()
    for a, b in zip(px[:-1], py[:-1]):
        loss = loss + charbonnier(a, b)
    return loss


def gw_loss(x, y, w=4.0):
    c = x.shape[1]

    def sobel(t, k):
        return F.conv2d(t, k.to(t).expand(c, 1, 3, 3), padding=1, groups=c)

    dx = (sobel(x, _SOBEL_X) - sobel(y, _SOBEL_X)).abs()
    dy = (sobel(x, _SOBEL_Y) - sobel(y, _SOBEL_Y)).abs()
    return ((1 + w * dx) * (1 + w * dy) * (x - y).abs()).mean()


def split_loss(pred, gt_c, recipe: dict):
    """(l_y, l_c) of NCHW prediction and centre GT."""
    if (recipe["pixel_criterion_y"], recipe["pixel_criterion_c"]) != \
            ("lappyr", "gw"):
        raise NotImplementedError("only the lappyr / gw Split recipe")
    return (recipe["pixel_weight_y"] * lap_pyr_loss(pred[:, :1], gt_c[:, :1]),
            recipe["pixel_weight_c"] * gw_loss(pred[:, 1:], gt_c[:, 1:]))


# ---- the step ------------------------------------------------------------------
def loss_and_grads(net, params, lq, gt, recipe, max_offset, block):
    """Split losses of the whole batch (lq, gt: (B, T, H, W, C) after
    augmentation) and the gradients of their sum in ``.grad``, taken in
    blocks of ``block`` rows."""
    b = lq.shape[0]
    center = net["nframes"] // 2
    tot_y = tot_c = 0.0
    for s in range(0, b, block):
        q, g = lq[s:s + block], gt[s:s + block, center]
        pred = edvr.forward(net, params, q, max_offset)[0]
        l_y, l_c = split_loss(pred, g.permute(0, 3, 1, 2), recipe)
        share = q.shape[0] / b
        ((l_y + l_c) * share).backward()
        tot_y += l_y.item() * share
        tot_c += l_c.item() * share
    return tot_y, tot_c


def cosine_lr(recipe: dict, t: int) -> float:
    """The rate of update ``t`` (1-based) in the schedule's first period."""
    if recipe["lr_scheme"] != "CosineAnnealingLR_Restart":
        raise NotImplementedError(recipe["lr_scheme"])
    lr, eta = float(recipe["lr_G"]), float(recipe["eta_min"])
    period = recipe["T_period"][0]
    return eta + (lr - eta) * (1 + math.cos(math.pi * t / period)) / 2


class Adam:
    def __init__(self, params: dict, recipe: dict, eps: float = 1e-8):
        self.p = params
        self.b1, self.b2 = float(recipe["beta1"]), float(recipe["beta2"])
        self.eps, self.recipe, self.t = eps, recipe, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        lr = cosine_lr(self.recipe, self.t)
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = p.grad
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.sub_(lr * (self.m[k] / c1) / denom)
            p.grad = None
