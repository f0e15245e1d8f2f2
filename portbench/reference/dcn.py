"""Modulated deformable convolution (DCNv2), 3x3 / stride 1 / pad 1, as
mmcv's ``modulated_deform_conv`` defines it, in plain PyTorch.

For output pixel (y, x), tap (i, j) of deformable group g, the input of the
group's channels is sampled bilinearly at (y + i - 1 + dy, x + j - 1 + dx),
each of the four corners that lies outside the image counting as zero, and
multiplied by the tap's mask; the output is the sum over taps and channels
with the weight, plus the bias.  The offsets are laid out (g, tap, (dy,
dx)) on the channels, the mask (g, tap).  ``max_offset`` clamps each offset
to [-R, R] first (the deployment setting the benchmark's traffic states;
not part of mmcv).

The sampling is gathered tap by tap, so no 9x column tensor is built; rows
of the batch go in blocks of ``block`` and, where a gradient is needed,
each block is recomputed in the backward (``torch.utils.checkpoint``), so a
training batch at full size fits beside the rest of the reference.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.precision import FP32, Precision


def _bilinear(xg: torch.Tensor, py: torch.Tensor, px: torch.Tensor,
              h: int, w: int) -> torch.Tensor:
    """xg (B, G, Cg, H*W) sampled at (py, px) (B, G, H, W), zero outside:
    (B, G, Cg, H*W)."""
    b, g, cg, hw = xg.shape
    y0, x0 = torch.floor(py), torch.floor(px)
    ly, lx = py - y0, px - x0
    out = None
    for yy, wy in ((y0, 1 - ly), (y0 + 1, ly)):
        for xx, wx in ((x0, 1 - lx), (x0 + 1, lx)):
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).long()
            idx = idx.reshape(b, g, 1, hw).expand(b, g, cg, hw)
            wgt = (wy * wx * inside).reshape(b, g, 1, hw).to(xg.dtype)
            term = xg.gather(3, idx) * wgt
            out = term if out is None else out + term
    return out


def _dcn_block(x, offset, mask, weight, bias, dg: int, max_offset):
    b, c, h, w = x.shape
    cout = weight.shape[0]
    if max_offset is not None:
        offset = offset.clamp(-max_offset, max_offset)
    off = offset.reshape(b, dg, 9, 2, h, w).float()
    m = mask.reshape(b, dg, 9, h * w)
    xg = x.reshape(b, dg, c // dg, h * w)
    ys = torch.arange(h, device=x.device, dtype=torch.float32).view(h, 1)
    xs = torch.arange(w, device=x.device, dtype=torch.float32).view(1, w)
    out = None
    for k in range(9):
        i, j = divmod(k, 3)
        val = _bilinear(xg, ys + (i - 1) + off[:, :, k, 0],
                        xs + (j - 1) + off[:, :, k, 1], h, w)
        val = (val * m[:, :, k, None]).reshape(b, c, h * w)
        term = torch.einsum("oc,bcp->bop", weight[:, :, i, j], val)
        out = term if out is None else out + term
    out = out.reshape(b, cout, h, w)
    return out if bias is None else out + bias.view(1, cout, 1, 1)


def modulated_deform_conv(x, offset, mask, weight, bias, dg: int,
                          max_offset: float | None = None,
                          prec: Precision = FP32, block: int = 8):
    """x (B, C, H, W); offset (B, dg*18, H, W); mask (B, dg*9, H, W) in
    [0, 1]; weight (Cout, C, 3, 3); bias (Cout,).  ``prec`` rounds x and
    the weight (the control's lower precision)."""
    x, weight = prec.cast(x), prec.cast(weight)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, offset, mask, weight, bias))
    outs = []
    for s in range(0, x.shape[0], block):
        args = (x[s:s + block], offset[s:s + block], mask[s:s + block],
                weight, bias, dg, max_offset)
        outs.append(checkpoint(_dcn_block, *args, use_reentrant=False)
                    if grad else _dcn_block(*args))
    return torch.cat(outs) if len(outs) > 1 else outs[0]
