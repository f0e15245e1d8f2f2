"""Modulated deformable convolution (DCNv2), NHWC.

The plain PyTorch op is the exact DCNv2 of ``realvsr_tpu/ops/deform_conv.py``
(``modulated_deform_conv``, ``impl="columns"``): per tap, a bilinear sample of
the input at (tap + offset) with zero padding per corner, times the mask,
then one product with that tap's weights, accumulated over the taps in f32.

Layouts follow the reference CUDA op, as the JAX package does:
  * offset channels = (deformable_groups, K, 2) with (dh, dw) pairs,
  * mask channels   = (deformable_groups, K), already through the sigmoid,
  * taps ordered row-major over the kernel window (i * kw + j),
  * weight (cout, cin, kh, kw), the torch layout of the reference's modules.

``max_offset=R`` clamps every offset to [-R, R] first, reproducing the clip
of the JAX block and frame paths (``ops/deform_conv_block.py:417``); None
keeps the exact op.  ``act="lrelu"`` applies LeakyReLU(0.1) after the bias.

:func:`modulated_deform_conv` sends a CUDA tensor to the hand-written
forward and backward kernels (:func:`realvsr_tpu_torch.ops.kernels.dcn.
dcn_autograd`, 3x3 / stride 1 / pad 1) and a CPU tensor to
:func:`modulated_deform_conv_plain`, which autograd differentiates; its
``clamp`` passes the offset gradient on [-R, R] inclusive, as the JAX
package's clip (``deform_conv_block.py::_fold_dcoord``) and the backward
kernel do.  :func:`modulated_deform_conv_om` is the same op fed with
DCNPack's ``conv_offset_mask`` output as it is (:func:`split_om`): the
kernels read it in place and take the sigmoid themselves.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _out_size(n: int, k: int, stride: int, pad: int, dil: int) -> int:
    return (n + 2 * pad - (dil * (k - 1) + 1)) // stride + 1


def apply_act(y: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return y
    if act == "relu":
        return F.relu(y)
    if act == "lrelu":
        return F.leaky_relu(y, 0.1)
    raise ValueError(f"unknown activation {act!r}")


def act_grad(g: torch.Tensor, y: torch.Tensor, act: str | None):
    """The cotangent before :func:`apply_act`, from its output ``y``
    (LeakyReLU(0.1): slope 1 where y >= 0, as the JAX package's
    ``jnp.where(x >= 0, ...)``)."""
    if act is None:
        return g
    if act == "lrelu":
        return torch.where(y >= 0, g, g * 0.1)
    if act == "relu":
        return torch.where(y > 0, g, torch.zeros_like(g))
    raise ValueError(f"unknown activation {act!r}")


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                                mask: torch.Tensor | None,
                                weight: torch.Tensor,
                                bias: torch.Tensor | None = None,
                                stride=1, padding=1, dilation=1,
                                deformable_groups: int = 1,
                                max_offset: float | None = None,
                                act: str | None = None) -> torch.Tensor:
    """Exact DCNv2 forward in plain PyTorch.

    Sampling and accumulation are f32 whatever the input type; the sampled
    columns are rounded to the input type before the product, as the tensor
    cores take them, and the output is cast back to the input type after
    bias and activation.

    x: (B, H, W, Cin); offset: (B, Ho, Wo, dg*K*2); mask: (B, Ho, Wo, dg*K)
    or None; weight: (Cout, Cin, kh, kw).  Returns (B, Ho, Wo, Cout).
    """
    b, h, w, cin = x.shape
    cout, cin_w, kh, kw = weight.shape
    if cin_w != cin:
        raise ValueError(f"weight takes {cin_w} input channels, x has {cin}")
    k = kh * kw
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg = deformable_groups
    cpg = cin // dg
    ho = _out_size(h, kh, sh, ph, dh)
    wo = _out_size(w, kw, sw, pw, dw)
    dev = x.device

    off = offset.float().reshape(b, ho, wo, dg, k, 2)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = None if mask is None else mask.float().reshape(b, ho, wo, dg, k)
    xf = x.float().reshape(b * h * w * dg, cpg)  # rows (b, y, x, g)
    oy = (torch.arange(ho, device=dev, dtype=torch.float32) * sh - ph)
    ox = (torch.arange(wo, device=dev, dtype=torch.float32) * sw - pw)
    oy = oy[None, :, None, None]
    ox = ox[None, None, :, None]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    gi = torch.arange(dg, device=dev)
    wt = weight.float().permute(2, 3, 1, 0).reshape(k, cin, cout)
    acc = torch.zeros(b * ho * wo, cout, device=dev, dtype=torch.float32)

    for t in range(k):
        i, j = divmod(t, kw)
        py = oy + i * dh + off[..., t, 0]  # (B, Ho, Wo, dg)
        px = ox + j * dw + off[..., t, 1]
        y0 = torch.floor(py)
        x0 = torch.floor(px)
        ty = py - y0
        tx = px - x0
        val = None
        for yc, xc, wgt in ((y0, x0, (1 - ty) * (1 - tx)),
                            (y0, x0 + 1, (1 - ty) * tx),
                            (y0 + 1, x0, ty * (1 - tx)),
                            (y0 + 1, x0 + 1, ty * tx)):
            valid = (yc >= 0) & (yc <= h - 1) & (xc >= 0) & (xc <= w - 1)
            wgt = torch.where(valid, wgt, torch.zeros_like(wgt))
            yi = yc.clamp(0, h - 1).long()
            xi = xc.clamp(0, w - 1).long()
            term = xf[((bi * h + yi) * w + xi) * dg + gi] * wgt[..., None]
            val = term if val is None else val + term
        if msk is not None:
            val = val * msk[..., t, None]
        cols = val.reshape(b * ho * wo, cin).to(x.dtype).float()
        acc = acc + cols @ wt[t]
    if bias is not None:
        acc = acc + bias.float()
    return apply_act(acc, act).reshape(b, ho, wo, cout).to(x.dtype)


def split_om(om: torch.Tensor, deformable_groups: int):
    """(offset, mask) of DCNPack's (..., dg*27) offset/mask tensor: the
    first dg*18 channels are concat(o1, o2), the offsets in the (dg, tap,
    (dy, dx)) layout, and the mask is the sigmoid of the rest
    (``realvsr_tpu/models/common.py::DCNPack``)."""
    n = deformable_groups * 18
    return om[..., :n], torch.sigmoid(om[..., n:])


def modulated_deform_conv_om(x: torch.Tensor, om: torch.Tensor,
                             weight: torch.Tensor,
                             bias: torch.Tensor | None = None,
                             deformable_groups: int = 8,
                             max_offset: float | None = None,
                             act: str | None = None) -> torch.Tensor:
    """Differentiable DCNv2 3x3 / stride 1 / pad 1 from ``om`` (B, H, W,
    dg*27), DCNPack's ``conv_offset_mask`` output: for a CUDA tensor the
    kernels read it in place (:func:`realvsr_tpu_torch.ops.kernels.dcn.
    dcn_om_autograd`); for a CPU tensor :func:`modulated_deform_conv_plain`
    of :func:`split_om`."""
    if x.device.type == "cpu":
        return modulated_deform_conv_plain(
            x, *split_om(om, deformable_groups), weight, bias, 1, 1, 1,
            deformable_groups, max_offset, act)
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_om_autograd

    return dcn_om_autograd(x, om, weight, bias, deformable_groups, act=act,
                           max_offset=max_offset)


def modulated_deform_conv(x: torch.Tensor, offset: torch.Tensor,
                          mask: torch.Tensor | None, weight: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          stride=1, padding=1, dilation=1,
                          deformable_groups: int = 1,
                          max_offset: float | None = None,
                          act: str | None = None) -> torch.Tensor:
    """Differentiable DCNv2: the hand-written kernels for a CUDA tensor,
    the plain op for a CPU tensor.  See :func:`modulated_deform_conv_plain`."""
    if x.device.type == "cpu":
        return modulated_deform_conv_plain(
            x, offset, mask, weight, bias, stride, padding, dilation,
            deformable_groups, max_offset, act)
    if (tuple(weight.shape[2:]), _pair(stride), _pair(padding),
            _pair(dilation)) != ((3, 3), (1, 1), (1, 1), (1, 1)):
        raise ValueError("the DCN kernel takes 3x3 / stride 1 / pad 1 / "
                         "dilation 1 only")
    if mask is None:
        raise ValueError("the DCN kernel takes a mask (DCNv2)")
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_autograd

    return dcn_autograd(x, offset, mask, weight, bias, deformable_groups,
                        act=act, max_offset=max_offset)
