"""Deformable convolution, modulated (DCNv2) and not (DCNv1), NHWC.

The plain PyTorch op is the exact DCNv2 of ``realvsr_tpu/ops/deform_conv.py``
(``modulated_deform_conv``, ``impl="columns"``): per tap, a bilinear sample of
the input at (tap + offset) with zero padding per corner, times the mask
(none for DCNv1), then one product with that tap's weights (per group of
``groups`` where the conv is grouped), accumulated over the taps in f32.

Layouts follow the reference CUDA op, as the JAX package does:
  * offset channels = (deformable_groups, K, 2) with (dh, dw) pairs,
  * mask channels   = (deformable_groups, K), already through the sigmoid,
  * taps ordered row-major over the kernel window (i * kw + j),
  * weight (cout, cin // groups, kh, kw), the torch layout of the
    reference's modules.

``max_offset=R`` clamps every offset to [-R, R] first, reproducing the clip
of the JAX block and frame paths (``ops/deform_conv_block.py:417``); None
keeps the exact op.  ``act="lrelu"`` applies LeakyReLU(0.1) after the bias.

The shape decides the implementation, as it does in the JAX package
(``realvsr_tpu/ops/deform_conv.py:290-296``, where only 3x3 / s1 / p1 / d1
/ groups 1 reaches a Pallas kernel and XLA runs every other shape):

* 3x3 / stride 1 / pad 1 / dilation 1 / groups 1, mask or none:
  :func:`modulated_deform_conv` sends a CUDA tensor to the hand-written
  forward and backward kernels (:func:`realvsr_tpu_torch.ops.kernels.dcn.
  dcn_autograd`, which launch a kernel or raise) and a CPU tensor to
  :func:`modulated_deform_conv_plain`, which autograd differentiates;
* any other kernel size, stride, padding, dilation or ``groups > 1``:
  :func:`modulated_deform_conv_plain` (the columns form taken a tap at a
  time: each tap's sampled columns times its weights, grouped as JAX's
  einsum) in stock PyTorch ops on either device, as XLA runs it for the
  JAX package.  This is a choice by shape, made before any kernel is
  asked, not a fallback from one.

The plain op's ``clamp`` passes the offset gradient on [-R, R] inclusive,
as the JAX package's clip (``deform_conv_block.py::_fold_dcoord``) and the
backward kernel do.  :func:`modulated_deform_conv_om` is the same op fed
with DCNPack's ``conv_offset_mask`` output as it is (:func:`split_om`): the
kernels read it in place and take the sigmoid themselves.
:func:`deform_conv` is DCNv1 (no mask, no bias), as JAX's.
"""
from __future__ import annotations

import numpy as np
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


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain forms' sampling and accumulation type: f32, or f64 for a
    float64 input (the parity tests' float64 runs)."""
    return torch.promote_types(x.dtype, torch.float32)


def _taps(x, offset, mask, kernel_size, stride, padding, dilation,
          deformable_groups, max_offset):
    """(output size (Ho, Wo), and per tap the masked bilinear sample of the
    input, (B * Ho * Wo, Cin) in f32 (f64 for a float64 input)), the
    sampling of every form."""
    b, h, w, cin = x.shape
    kh, kw = kernel_size
    k = kh * kw
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg = deformable_groups
    if dg < 1 or cin % dg:
        raise ValueError(f"{dg} deformable groups do not divide {cin} "
                         "input channels")
    cpg = cin // dg
    ho = _out_size(h, kh, sh, ph, dh)
    wo = _out_size(w, kw, sw, pw, dw)
    dev, ct = x.device, _acc_dtype(x)

    off = offset.to(ct).reshape(b, ho, wo, dg, k, 2)
    if max_offset is not None:
        off = off.clamp(-float(max_offset), float(max_offset))
    msk = None if mask is None else mask.to(ct).reshape(b, ho, wo, dg, k)
    xf = x.to(ct).reshape(b * h * w * dg, cpg)  # rows (b, y, x, g)
    oy = (torch.arange(ho, device=dev, dtype=ct) * sh - ph)
    ox = (torch.arange(wo, device=dev, dtype=ct) * sw - pw)
    oy = oy[None, :, None, None]
    ox = ox[None, None, :, None]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    gi = torch.arange(dg, device=dev)

    def sample(t):
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
        return val.reshape(b * ho * wo, cin)

    return (ho, wo), (sample(t) for t in range(k))


def _check_weight(x, weight, groups):
    cin = x.shape[-1]
    cout, cin_g = weight.shape[:2]
    if groups < 1 or cin % groups or cout % groups or cin_g * groups != cin:
        raise ValueError(f"weight {tuple(weight.shape)} does not take {cin} "
                         f"input channels in {groups} groups")


def modulated_deform_conv_plain(x: torch.Tensor, offset: torch.Tensor,
                                mask: torch.Tensor | None,
                                weight: torch.Tensor,
                                bias: torch.Tensor | None = None,
                                stride=1, padding=1, dilation=1,
                                deformable_groups: int = 1,
                                max_offset: float | None = None,
                                act: str | None = None,
                                groups: int = 1) -> torch.Tensor:
    """Exact DCNv2 forward in plain PyTorch, tap by tap.

    Sampling and accumulation are f32 whatever the input type (f64 for a
    float64 input); the sampled columns are rounded to the input type before
    the product, as the tensor cores take them, and the output is cast back
    to the input type after bias and activation.

    x: (B, H, W, Cin); offset: (B, Ho, Wo, dg*K*2); mask: (B, Ho, Wo, dg*K)
    or None (DCNv1); weight: (Cout, Cin // groups, kh, kw).  Returns (B,
    Ho, Wo, Cout).
    """
    b = x.shape[0]
    cout, cin_g, kh, kw = weight.shape
    _check_weight(x, weight, groups)
    k = kh * kw
    (ho, wo), taps = _taps(x, offset, mask, (kh, kw), stride, padding,
                           dilation, deformable_groups, max_offset)
    ct = _acc_dtype(x)
    wt = weight.to(ct).permute(2, 3, 1, 0).reshape(k, cin_g, cout)
    if groups > 1:  # (k, groups, cin_g, cout_g): group g's outputs
        wt = wt.reshape(k, cin_g, groups, cout // groups).transpose(1, 2)
    acc = torch.zeros(b * ho * wo, cout, device=x.device, dtype=ct)
    for t, val in enumerate(taps):
        cols = val.to(x.dtype).to(ct)
        if groups == 1:
            acc = acc + cols @ wt[t]
        else:
            acc = acc + torch.einsum(
                "ngi,gio->ngo", cols.reshape(-1, groups, cin_g),
                wt[t]).reshape(-1, cout)
    if bias is not None:
        acc = acc + bias.to(ct)
    return apply_act(acc, act).reshape(b, ho, wo, cout).to(x.dtype)


def deform_conv_columns(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor | None, kernel_size,
                        stride=1, padding=0, dilation=1,
                        deformable_groups: int = 1,
                        max_offset: float | None = None) -> torch.Tensor:
    """Deformable im2col (``realvsr_tpu/ops/deform_conv.py::
    deform_conv_columns``): the sampled, modulated columns, (B, Ho, Wo,
    Cin * K) in the input's dtype, channel-major then tap (column ci * K +
    k), the layout of a (Cout, Cin, kh, kw) weight flattened to (Cout, Cin
    * K).  Sampled in f32 and rounded once; ``max_offset`` clamps the
    offsets first (None: exact)."""
    b = x.shape[0]
    kh, kw = _pair(kernel_size)
    (ho, wo), taps = _taps(x, offset, mask, (kh, kw), stride, padding,
                           dilation, deformable_groups, max_offset)
    cols = torch.stack(list(taps), -1)   # (B * Ho * Wo, Cin, K)
    return cols.reshape(b, ho, wo, -1).to(x.dtype)


def kernel_shape(weight: torch.Tensor, stride=1, padding=1, dilation=1,
                 groups: int = 1) -> bool:
    """The shapes the DCN kernels take (and the JAX package's Pallas path):
    3x3 / stride 1 / pad 1 / dilation 1 / groups 1."""
    return (tuple(weight.shape[2:]) == (3, 3) and _pair(stride) == (1, 1)
            and _pair(padding) == (1, 1) and _pair(dilation) == (1, 1)
            and groups == 1)


def split_om(om: torch.Tensor, deformable_groups: int):
    """(offset, mask) of DCNPack's (..., dg*3*K) offset/mask tensor (K taps,
    9 at 3x3): the first two thirds are concat(o1, o2), the offsets in the
    (dg, tap, (dy, dx)) layout, and the mask is the sigmoid of the rest
    (``realvsr_tpu/models/common.py::DCNPack``)."""
    n = om.shape[-1] // 3 * 2
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
                          act: str | None = None,
                          groups: int = 1) -> torch.Tensor:
    """Differentiable DCN (mask None: DCNv1), chosen by shape (module
    docstring): at 3x3 / s1 / p1 / d1 / groups 1 the hand-written kernels
    for a CUDA tensor; for a CPU tensor, and at any other shape on either
    device, :func:`modulated_deform_conv_plain`."""
    if x.device.type == "cpu" or not kernel_shape(weight, stride, padding,
                                                  dilation, groups):
        return modulated_deform_conv_plain(
            x, offset, mask, weight, bias, stride, padding, dilation,
            deformable_groups, max_offset, act, groups)
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_autograd

    return dcn_autograd(x, offset, mask, weight, bias, deformable_groups,
                        act=act, max_offset=max_offset)


def deform_conv(x: torch.Tensor, offset: torch.Tensor, weight: torch.Tensor,
                stride=1, padding=0, dilation=1, groups: int = 1,
                deformable_groups: int = 1) -> torch.Tensor:
    """DCNv1 (unmodulated, no bias; ``realvsr_tpu/ops/deform_conv.py::
    deform_conv``): :func:`modulated_deform_conv` with no mask, the
    arguments in JAX's order; weight (Cout, Cin // groups, kh, kw)."""
    return modulated_deform_conv(x, offset, None, weight, None, stride,
                                 padding, dilation, deformable_groups,
                                 groups=groups)


def modulated_deform_conv_np(x, offset, mask, weight, bias=None, stride=1,
                             padding=0, dilation=1, groups=1,
                             deformable_groups=1):
    """Loop-for-loop numpy oracle of the reference CUDA op
    (``realvsr_tpu/ops/deform_conv.py::modulated_deform_conv_np``), float64,
    tiny inputs only.  x (B, H, W, Cin); weight in the port's layout (Cout,
    Cin // groups, kh, kw); mask None for DCNv1."""
    b, h, w, cin = x.shape
    cout, cin_g, kh, kw = weight.shape
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg = deformable_groups
    cpg = cin // dg
    k = kh * kw
    ho = _out_size(h, kh, sh, ph, dh)
    wo = _out_size(w, kw, sw, pw, dw)
    off = np.asarray(offset, np.float64).reshape(b, ho, wo, dg, k, 2)
    msk = (None if mask is None
           else np.asarray(mask, np.float64).reshape(b, ho, wo, dg, k))
    x = np.asarray(x, np.float64)
    weight = np.asarray(weight, np.float64)
    out = np.zeros((b, ho, wo, cout), dtype=np.float64)

    def sample(img2d, y, x_):
        hh, ww = img2d.shape
        if y <= -1 or y >= hh or x_ <= -1 or x_ >= ww:
            return 0.0
        y0, x0 = int(np.floor(y)), int(np.floor(x_))
        ty, tx = y - y0, x_ - x0
        v = 0.0
        for yy, wy in ((y0, 1 - ty), (y0 + 1, ty)):
            for xx, wx in ((x0, 1 - tx), (x0 + 1, tx)):
                if 0 <= yy < hh and 0 <= xx < ww:
                    v += wy * wx * img2d[yy, xx]
        return v

    og = cout // groups
    for bi in range(b):
        for yo in range(ho):
            for xo in range(wo):
                for g in range(groups):
                    for co in range(og):
                        acc = 0.0
                        for ci in range(cin_g):
                            c_abs = g * cin_g + ci
                            dgi = c_abs // cpg
                            for i in range(kh):
                                for j in range(kw):
                                    t = i * kw + j
                                    y = (yo * sh - ph + i * dh
                                         + off[bi, yo, xo, dgi, t, 0])
                                    x_ = (xo * sw - pw + j * dw
                                          + off[bi, yo, xo, dgi, t, 1])
                                    v = sample(x[bi, :, :, c_abs], y, x_)
                                    if msk is not None:
                                        v *= msk[bi, yo, xo, dgi, t]
                                    acc += v * weight[g * og + co, ci, i, j]
                        out[bi, yo, xo, g * og + co] = acc
    if bias is not None:
        out += np.asarray(bias, np.float64)
    return out
