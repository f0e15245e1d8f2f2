"""EDVR (xinntao/EDVR ``EDVR_arch.py``) and RealVSR's EDVR_NoUp, in plain
PyTorch, NCHW, from a dict of parameters.

The layers and their order are the published ones: the per-frame feature
pyramid (``conv_first``, ``front_RBs`` residual blocks, two stride-2
levels), PCD alignment (pyramid, cascading, DCNv2 packs with their offset
and mask conv), fusion (TSA, or the 1x1 conv over the frames' concatenated
features of the ``w_TSA: false`` variant), ``back_RBs`` residual blocks,
and the head: for EDVR two x2 pixel shuffles, ``HRconv``, ``conv_last``
and the centre frame resized x4 bilinearly added; for EDVR_NoUp
``HRconv``, ``conv_last`` and the centre frame added.  LeakyReLU slope 0.1.
Parameter names are the published modules' state-dict keys.

Departures from the published description:
  * ``max_offset`` clamps the DCN offsets to [-R, R] (the deployment
    setting the traffic states; the published DCN has no clamp);
  * ``predeblur`` and ``HR_in`` are not built (no configuration here uses
    them): :func:`param_specs` raises on them.

``forward`` returns the restored frame and its residual (the output less
the centre frame, or less its x4 resize), so a check can measure a gap
against what the network itself adds.  Every convolution and DCN adds its
multiply-accumulates x 2 to a :class:`Flops` counter when one is given;
:func:`model_flops` counts one forward at a shape on the meta device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.dcn import modulated_deform_conv
from portbench.reference.precision import FP32, Precision


class Flops:
    """A running count of model operations (2 x multiply-accumulates)."""

    def __init__(self):
        self.total = 0

    def add(self, n: int) -> None:
        self.total += int(n)


def _conv_spec(name, cin, cout, k=3, kind="default"):
    return [(f"{name}.weight", (cout, cin, k, k), kind, cin * k * k),
            (f"{name}.bias", (cout,), kind + "_bias", cin * k * k)]


def _resblocks(name, nf, n):
    specs = []
    for i in range(n):
        specs += _conv_spec(f"{name}.{i}.conv1", nf, nf, kind="residual")
        specs += _conv_spec(f"{name}.{i}.conv2", nf, nf, kind="residual")
    return specs


def _dcnpack_spec(name, nf, dg):
    return (_conv_spec(f"{name}.conv_offset_mask", nf, dg * 27,
                       kind="offset")
            + [(f"{name}.weight", (nf, nf, 3, 3), "default", nf * 9),
               (f"{name}.bias", (nf,), "default_bias", nf * 9)])


def param_specs(net: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, init kind, fan-in) of every parameter of the network
    that ``net`` (the ``network_G`` section) describes."""
    if net.get("predeblur") or net.get("HR_in"):
        raise NotImplementedError("predeblur / HR_in are not built here")
    nf, n, dg = net["nf"], net["nframes"], net["groups"]
    specs = _conv_spec("conv_first", net["nc"], nf)
    specs += _resblocks("feature_extraction", nf, net["front_RBs"])
    for lv in ("L2", "L3"):
        specs += _conv_spec(f"fea_{lv}_conv1", nf, nf)
        specs += _conv_spec(f"fea_{lv}_conv2", nf, nf)
    p = "pcd_align"
    specs += _conv_spec(f"{p}.L3_offset_conv1", 2 * nf, nf)
    specs += _conv_spec(f"{p}.L3_offset_conv2", nf, nf)
    specs += _dcnpack_spec(f"{p}.L3_dcnpack", nf, dg)
    for lv in ("L2", "L1"):
        specs += _conv_spec(f"{p}.{lv}_offset_conv1", 2 * nf, nf)
        specs += _conv_spec(f"{p}.{lv}_offset_conv2", 2 * nf, nf)
        specs += _conv_spec(f"{p}.{lv}_offset_conv3", nf, nf)
        specs += _dcnpack_spec(f"{p}.{lv}_dcnpack", nf, dg)
        specs += _conv_spec(f"{p}.{lv}_fea_conv", 2 * nf, nf)
    specs += _conv_spec(f"{p}.cas_offset_conv1", 2 * nf, nf)
    specs += _conv_spec(f"{p}.cas_offset_conv2", nf, nf)
    specs += _dcnpack_spec(f"{p}.cas_dcnpack", nf, dg)
    if net.get("w_TSA"):
        t = "tsa_fusion"
        for name, cin, k in (("tAtt_1", nf, 3), ("tAtt_2", nf, 3),
                             ("fea_fusion", n * nf, 1), ("sAtt_1", n * nf, 1),
                             ("sAtt_2", 2 * nf, 1), ("sAtt_3", nf, 3),
                             ("sAtt_4", nf, 1), ("sAtt_5", nf, 3),
                             ("sAtt_L1", nf, 1), ("sAtt_L2", 2 * nf, 3),
                             ("sAtt_L3", nf, 3), ("sAtt_add_1", nf, 1),
                             ("sAtt_add_2", nf, 1)):
            specs += _conv_spec(f"{t}.{name}", cin, nf, k)
    else:
        specs += _conv_spec("tsa_fusion", n * nf, nf, 1)
    specs += _resblocks("recon_trunk", nf, net["back_RBs"])
    if net["which_model_G"] == "EDVR":
        specs += _conv_spec("upconv1", nf, nf * 4)
        specs += _conv_spec("upconv2", nf, 64 * 4)
        specs += _conv_spec("HRconv", 64, 64)
    else:
        specs += _conv_spec("HRconv", nf, 64)
    specs += _conv_spec("conv_last", 64, net["nc"])
    return specs


class _Net:
    """One forward's state: the parameters, the precision, the counter."""

    def __init__(self, net, params, prec: Precision, fl: Flops | None,
                 max_offset):
        self.net, self.p, self.prec, self.fl = net, params, prec, fl
        self.max_offset = max_offset

    def conv(self, x, name, stride=1, act=None):
        w = self.p[f"{name}.weight"]
        k = w.shape[-1]
        y = F.conv2d(self.prec.cast(x), self.prec.cast(w),
                     self.p[f"{name}.bias"], stride, k // 2)
        if self.fl is not None:
            self.fl.add(2 * y.numel() * w.shape[1] * k * k)
        return _act(y, act)

    def resblocks(self, x, name, n):
        for i in range(n):
            y = self.conv(x, f"{name}.{i}.conv1", act="relu")
            x = x + self.conv(y, f"{name}.{i}.conv2")
        return x

    def dcnpack(self, x, feat, name, act=None):
        om = self.conv(feat, f"{name}.conv_offset_mask")
        o1, o2, m = torch.chunk(om, 3, dim=1)
        w = self.p[f"{name}.weight"]
        if self.fl is not None:
            self.fl.add(2 * x.shape[0] * x.shape[2] * x.shape[3]
                        * w.shape[0] * w.shape[1] * 9)
        if x.is_meta:
            y = x.new_empty(x.shape[0], w.shape[0], *x.shape[2:])
        else:
            y = modulated_deform_conv(
                x, torch.cat([o1, o2], 1), torch.sigmoid(m), w,
                self.p[f"{name}.bias"], self.net["groups"], self.max_offset,
                self.prec)
        return _act(y, act)


def _act(y, act):
    if act == "lrelu":
        return F.leaky_relu(y, 0.1)
    if act == "relu":
        return F.relu(y)
    return y


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def _pcd(m: _Net, nbr, ref):
    p = "pcd_align"
    l3_off = m.conv(torch.cat([nbr[2], ref[2]], 1), f"{p}.L3_offset_conv1",
                    act="lrelu")
    l3_off = m.conv(l3_off, f"{p}.L3_offset_conv2", act="lrelu")
    l3_fea = m.dcnpack(nbr[2], l3_off, f"{p}.L3_dcnpack", act="lrelu")
    l2_off = m.conv(torch.cat([nbr[1], ref[1]], 1), f"{p}.L2_offset_conv1",
                    act="lrelu")
    l2_off = m.conv(torch.cat([l2_off, _up2(l3_off) * 2], 1),
                    f"{p}.L2_offset_conv2", act="lrelu")
    l2_off = m.conv(l2_off, f"{p}.L2_offset_conv3", act="lrelu")
    l2_fea = m.dcnpack(nbr[1], l2_off, f"{p}.L2_dcnpack")
    l2_fea = m.conv(torch.cat([l2_fea, _up2(l3_fea)], 1), f"{p}.L2_fea_conv",
                    act="lrelu")
    l1_off = m.conv(torch.cat([nbr[0], ref[0]], 1), f"{p}.L1_offset_conv1",
                    act="lrelu")
    l1_off = m.conv(torch.cat([l1_off, _up2(l2_off) * 2], 1),
                    f"{p}.L1_offset_conv2", act="lrelu")
    l1_off = m.conv(l1_off, f"{p}.L1_offset_conv3", act="lrelu")
    l1_fea = m.dcnpack(nbr[0], l1_off, f"{p}.L1_dcnpack")
    l1_fea = m.conv(torch.cat([l1_fea, _up2(l2_fea)], 1), f"{p}.L1_fea_conv")
    off = m.conv(torch.cat([l1_fea, ref[0]], 1), f"{p}.cas_offset_conv1",
                 act="lrelu")
    off = m.conv(off, f"{p}.cas_offset_conv2", act="lrelu")
    return m.dcnpack(l1_fea, off, f"{p}.cas_dcnpack", act="lrelu")


def _pool_pair(x):
    return torch.cat([F.max_pool2d(x, 3, 2, 1), F.avg_pool2d(x, 3, 2, 1)], 1)


def _tsa(m: _Net, aligned, center):
    """aligned (B, N, C, H, W) -> (B, C, H, W)."""
    t = "tsa_fusion"
    b, n, c, h, w = aligned.shape
    emb_ref = m.conv(aligned[:, center], f"{t}.tAtt_2")
    emb = m.conv(aligned.reshape(b * n, c, h, w), f"{t}.tAtt_1").reshape(
        b, n, -1, h, w)
    cor = torch.sigmoid((emb * emb_ref[:, None]).sum(2))      # (B, N, H, W)
    fea_w = (aligned * cor[:, :, None]).reshape(b, n * c, h, w)
    fea = m.conv(fea_w, f"{t}.fea_fusion", act="lrelu")
    att = m.conv(fea_w, f"{t}.sAtt_1", act="lrelu")
    att = m.conv(_pool_pair(att), f"{t}.sAtt_2", act="lrelu")
    att_l = m.conv(att, f"{t}.sAtt_L1", act="lrelu")
    att_l = m.conv(_pool_pair(att_l), f"{t}.sAtt_L2", act="lrelu")
    att_l = _up2(m.conv(att_l, f"{t}.sAtt_L3", act="lrelu"))
    att = m.conv(att, f"{t}.sAtt_3", act="lrelu") + att_l
    att = m.conv(att, f"{t}.sAtt_4", act="lrelu")
    att = m.conv(_up2(att), f"{t}.sAtt_5")
    att_add = m.conv(m.conv(att, f"{t}.sAtt_add_1", act="lrelu"),
                     f"{t}.sAtt_add_2")
    return fea * torch.sigmoid(att) * 2 + att_add


def forward(net: dict, params: dict, x: torch.Tensor,
            max_offset: float | None = None, prec: Precision = FP32,
            fl: Flops | None = None):
    """x: (B, N, H, W, C) frames, channels last as the benchmark holds them.
    Returns (output, residual), both (B, C, H', W'), float32."""
    m = _Net(net, params, prec, fl, max_offset)
    x = x.permute(0, 1, 4, 2, 3).float()
    b, n, c, h, w = x.shape
    center = net["nframes"] // 2 if net.get("center") is None \
        else net["center"]
    nf = net["nf"]
    l1 = m.conv(x.reshape(b * n, c, h, w), "conv_first", act="lrelu")
    l1 = m.resblocks(l1, "feature_extraction", net["front_RBs"])
    l2 = m.conv(m.conv(l1, "fea_L2_conv1", 2, "lrelu"), "fea_L2_conv2",
                act="lrelu")
    l3 = m.conv(m.conv(l2, "fea_L3_conv1", 2, "lrelu"), "fea_L3_conv2",
                act="lrelu")
    nbr, ref = [], []
    for lv in (l1, l2, l3):
        v = lv.reshape(b, n, *lv.shape[1:])
        nbr.append(lv)
        ref.append(v[:, center:center + 1].expand(v.shape).reshape(lv.shape))
    aligned = _pcd(m, nbr, ref).reshape(b, n, nf, h, w)
    if net.get("w_TSA"):
        fea = _tsa(m, aligned, center)
    else:
        fea = m.conv(aligned.reshape(b, n * nf, h, w), "tsa_fusion")
    out = m.resblocks(fea, "recon_trunk", net["back_RBs"])
    x_center = x[:, center]
    if net["which_model_G"] == "EDVR":
        out = F.pixel_shuffle(m.conv(out, "upconv1"), 2)
        out = F.pixel_shuffle(m.conv(F.leaky_relu(out, 0.1), "upconv2"), 2)
        out = m.conv(F.leaky_relu(out, 0.1), "HRconv", act="lrelu")
        res = m.conv(out, "conv_last")
        base = F.interpolate(x_center, scale_factor=4, mode="bilinear",
                             align_corners=False)
    else:
        res = m.conv(m.conv(out, "HRconv", act="lrelu"), "conv_last")
        base = x_center
    return res + base, res


def model_flops(net: dict, shape: tuple) -> int:
    """Operations of one forward at ``shape`` (B, N, H, W, C), counted on the
    meta device from the layers above (convolutions and DCNs; the
    elementwise work and the sampling are not counted)."""
    specs = param_specs(net)
    params = {k: torch.empty(s, device="meta") for k, s, _, _ in specs}
    fl = Flops()
    forward(net, params, torch.empty(shape, device="meta"), fl=fl)
    return fl.total
