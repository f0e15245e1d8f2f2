"""BasicVSR++ (Chan et al., CVPR 2022, arXiv:2104.13371; open-mmlab/
mmediting's ``basicvsr_pp.py`` with its ``SPyNet`` and
``SecondOrderDeformableAlignment``) in plain PyTorch, NCHW, float32, from
a dict of parameters named as mmediting's state dict.

The layers are the published ones: ``feat_extract`` (a 3 -> mid conv with
LeakyReLU(0.1) and 5 residual blocks) over every frame; SPyNet's flows
between neighbouring frames in both directions (six levels of five 7x7
convs, the input normalised by ImageNet's mean and std and resized to a
multiple of 32, ``avg_pool2d`` pyramids, each coarser flow upsampled with
``align_corners=True`` and doubled, warps with border padding, the flow
resized back and rescaled); four propagation branches (``backward_1``,
``forward_1``, ``backward_2``, ``forward_2``), each step warping the
previous output by flow n-1 and, from the second step, the output two
steps back by the composed flow, then the second-order deformable
alignment (offsets ``max_residue_magnitude`` x tanh of the offset convs'
residues plus each flow flipped to (dy, dx), the mask's sigmoid, a DCNv2
of 2 x mid -> mid in 16 groups with exact offsets) and the branch's
residual blocks on the concatenated features; per frame, ``reconstruction``
on the five feature maps, two pixel-shuffle x2 stages with LeakyReLU,
``conv_hr`` with LeakyReLU, ``conv_last``, plus the frame resized x4
bilinearly.  Warps are mmediting's ``flow_warp`` (``grid_sample``,
``align_corners=True``).

Departures from mmediting:
  * SPyNet's weights are the seeded ones the benchmark hands in, not the
    pretrained ones (nor anything else of a trained model);
  * no ``cpu_cache`` (everything stays on the device);
  * the mirror-extended shortcut is not taken: the forward flows are
    computed, which for a clip that reads the same backwards gives the
    backward ones reversed, as the shortcut would;
  * ``is_low_res_input=False`` is not built (:func:`param_specs` raises).

:func:`forward` returns the outputs and residuals (the outputs less the
bilinear x4 frames) of the frames asked for, the whole clip's propagation
run either way.  Every convolution and DCN adds its multiply-accumulates x
2 to a :class:`~portbench.reference.edvr.Flops` counter when one is given;
:func:`model_flops` counts a clip on the meta device, per frame.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import edvr
from portbench.reference.dcn import modulated_deform_conv
from portbench.reference.edvr import Flops, _conv_spec, _resblocks
from portbench.reference.precision import FP32, Precision

BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")
DEFORM_GROUPS = 16
SPYNET_WIDTHS = (8, 32, 64, 32, 16, 2)
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _with_input_conv(name, cin, cout, n):
    return _conv_spec(f"{name}.main.0", cin, cout) + \
        _resblocks(f"{name}.main.2", cout, n)


def param_specs(net: dict) -> list[tuple[str, tuple, str, int]]:
    """(name, shape, init kind, fan-in) of every parameter of the network
    that ``net`` (the ``network_G`` section) describes; SPyNet's ImageNet
    mean and std are buffers (:func:`buffers`)."""
    if not net.get("is_low_res_input", True):
        raise NotImplementedError("is_low_res_input=False is not built here")
    mid, nb = net["mid_channels"], net["num_blocks"]
    w = SPYNET_WIDTHS
    specs = []
    for lv in range(6):
        for i in range(5):
            specs += _conv_spec(
                f"spynet.basic_module.{lv}.basic_module.{i}.conv", w[i],
                w[i + 1], k=7)
    specs += _with_input_conv("feat_extract", 3, mid, 5)
    for i, m in enumerate(BRANCHES):
        p = f"deform_align.{m}"
        specs += _conv_spec(f"{p}.conv_offset.0", 3 * mid + 4, mid)
        specs += _conv_spec(f"{p}.conv_offset.2", mid, mid)
        specs += _conv_spec(f"{p}.conv_offset.4", mid, mid)
        specs += _conv_spec(f"{p}.conv_offset.6", mid, 27 * DEFORM_GROUPS,
                            kind="offset")
        specs += [(f"{p}.weight", (mid, 2 * mid, 3, 3), "default",
                   2 * mid * 9),
                  (f"{p}.bias", (mid,), "default_bias", 2 * mid * 9)]
        specs += _with_input_conv(f"backbone.{m}", (2 + i) * mid, mid, nb)
    specs += _with_input_conv("reconstruction", 5 * mid, mid, 5)
    specs += _conv_spec("upsample1.upsample_conv", mid, mid * 4)
    specs += _conv_spec("upsample2.upsample_conv", mid, 64 * 4)
    specs += _conv_spec("conv_hr", 64, 64)
    specs += _conv_spec("conv_last", 64, 3)
    return specs


def buffers(device) -> dict:
    """SPyNet's buffers, as mmediting's state dict holds them."""
    return {"spynet.mean": torch.tensor(MEAN, device=device).view(1, 3, 1, 1),
            "spynet.std": torch.tensor(STD, device=device).view(1, 3, 1, 1)}


def flow_warp(x, flow, padding_mode="zeros"):
    """mmediting's ``flow_warp``: x (N, C, H, W) sampled at the pixel grid
    plus ``flow`` (N, H, W, 2), (dx, dy)."""
    if x.is_meta:
        return torch.empty_like(x)
    _, _, h, w = x.shape
    gy, gx = torch.meshgrid(torch.arange(h, device=x.device),
                            torch.arange(w, device=x.device), indexing="ij")
    grid = torch.stack((gx, gy), 2).to(x) + flow
    gx = 2.0 * grid[..., 0] / max(w - 1, 1) - 1.0
    gy = 2.0 * grid[..., 1] / max(h - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack((gx, gy), dim=3), mode="bilinear",
                         padding_mode=padding_mode, align_corners=True)


class _Net(edvr._Net):
    """One forward's state (parameters, precision, counter) and its
    layers."""

    def with_input_conv(self, x, name, n):
        x = self.conv(x, f"{name}.main.0", act="lrelu")
        return self.resblocks(x, f"{name}.main.2", n)

    def spynet_flow(self, ref, supp):
        mean = torch.tensor(MEAN, device=ref.device).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=ref.device).view(1, 3, 1, 1)
        ref, supp = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(5):
            ref.append(F.avg_pool2d(ref[-1], 2, 2, count_include_pad=False))
            supp.append(F.avg_pool2d(supp[-1], 2, 2,
                                     count_include_pad=False))
        ref, supp = ref[::-1], supp[::-1]
        n, _, h, w = ref[0].shape
        flow = ref[0].new_zeros(n, 2, h, w)
        for lv in range(6):
            flow_up = flow if lv == 0 else F.interpolate(
                flow, scale_factor=2, mode="bilinear",
                align_corners=True) * 2.0
            x = torch.cat([ref[lv], flow_warp(supp[lv], flow_up.permute(
                0, 2, 3, 1), "border"), flow_up], 1)
            for i in range(5):
                x = self.conv(x, f"spynet.basic_module.{lv}.basic_module."
                              f"{i}.conv", act="relu" if i < 4 else None)
            flow = flow_up + x
        return flow

    def spynet(self, ref, supp):
        h, w = ref.shape[2:4]
        w_up = w if w % 32 == 0 else 32 * (w // 32 + 1)
        h_up = h if h % 32 == 0 else 32 * (h // 32 + 1)
        ref = F.interpolate(ref, size=(h_up, w_up), mode="bilinear",
                            align_corners=False)
        supp = F.interpolate(supp, size=(h_up, w_up), mode="bilinear",
                             align_corners=False)
        flow = F.interpolate(self.spynet_flow(ref, supp), size=(h, w),
                             mode="bilinear", align_corners=False)
        return torch.stack([flow[:, 0] * (float(w) / float(w_up)),
                            flow[:, 1] * (float(h) / float(h_up))], 1)

    def align(self, name, x, extra, flow_1, flow_2):
        p = f"deform_align.{name}"
        out = torch.cat([extra, flow_1, flow_2], dim=1)
        for i in (0, 2, 4):
            out = self.conv(out, f"{p}.conv_offset.{i}", act="lrelu")
        out = self.conv(out, f"{p}.conv_offset.6")
        o1, o2, mask = torch.chunk(out, 3, dim=1)
        offset = self.net.get("max_residue_magnitude", 10) * torch.tanh(
            torch.cat((o1, o2), dim=1))
        offset_1, offset_2 = torch.chunk(offset, 2, dim=1)
        offset_1 = offset_1 + flow_1.flip(1).repeat(
            1, offset_1.size(1) // 2, 1, 1)
        offset_2 = offset_2 + flow_2.flip(1).repeat(
            1, offset_2.size(1) // 2, 1, 1)
        offset = torch.cat([offset_1, offset_2], dim=1)
        w = self.p[f"{p}.weight"]
        if self.fl is not None:
            self.fl.add(2 * x.shape[0] * x.shape[2] * x.shape[3]
                        * w.shape[0] * w.shape[1] * 9)
        if x.is_meta:
            return x.new_empty(x.shape[0], w.shape[0], *x.shape[2:])
        return modulated_deform_conv(x, offset, torch.sigmoid(mask), w,
                                     self.p[f"{p}.bias"], DEFORM_GROUPS,
                                     None, self.prec)

    def propagate(self, feats, flows, module):
        t = flows.shape[1] + 1
        frame_idx = range(0, t)
        flow_idx = range(-1, t - 1)
        if "backward" in module:
            frame_idx = frame_idx[::-1]
            flow_idx = frame_idx
        n, _, _, h, w = flows.shape
        feat_prop = flows.new_zeros(n, self.net["mid_channels"], h, w)
        feats[module] = []
        nb = self.net["num_blocks"]
        for i, idx in enumerate(frame_idx):
            feat_current = feats["spatial"][idx]
            if i > 0:
                flow_n1 = flows[:, flow_idx[i]]
                cond_n1 = flow_warp(feat_prop, flow_n1.permute(0, 2, 3, 1))
                feat_n2 = torch.zeros_like(feat_prop)
                flow_n2 = torch.zeros_like(flow_n1)
                cond_n2 = torch.zeros_like(cond_n1)
                if i > 1:
                    feat_n2 = feats[module][-2]
                    flow_n2 = flows[:, flow_idx[i - 1]]
                    flow_n2 = flow_n1 + flow_warp(flow_n2,
                                                  flow_n1.permute(0, 2, 3, 1))
                    cond_n2 = flow_warp(feat_n2, flow_n2.permute(0, 2, 3, 1))
                cond = torch.cat([cond_n1, feat_current, cond_n2], dim=1)
                feat_prop = torch.cat([feat_prop, feat_n2], dim=1)
                feat_prop = self.align(module, feat_prop, cond, flow_n1,
                                       flow_n2)
            feat = [feat_current] + [feats[k][idx] for k in feats
                                     if k not in ("spatial", module)]
            feat = torch.cat(feat + [feat_prop], dim=1)
            feat_prop = feat_prop + self.with_input_conv(
                feat, f"backbone.{module}", nb)
            feats[module].append(feat_prop)
        if "backward" in module:
            feats[module] = feats[module][::-1]

    def upsample(self, lq, feats, i):
        hr = torch.cat([feats["spatial"][i]]
                       + [feats[k][i] for k in BRANCHES], dim=1)
        hr = self.with_input_conv(hr, "reconstruction", 5)
        for up in ("upsample1", "upsample2"):
            hr = F.leaky_relu(F.pixel_shuffle(
                self.conv(hr, f"{up}.upsample_conv"), 2), 0.1)
        hr = self.conv(hr, "conv_hr", act="lrelu")
        res = self.conv(hr, "conv_last")
        return res + F.interpolate(lq, scale_factor=4, mode="bilinear",
                                   align_corners=False), res


def forward(net: dict, params: dict, x: torch.Tensor,
            prec: Precision = FP32, fl: Flops | None = None,
            frames=None):
    """x: (B, T, H, W, C) clip, channels last as the benchmark holds it.
    Returns (outputs, residuals), each (B, len(frames), C, 4H, 4W) in
    float32, of the frames asked for (all where ``frames`` is None)."""
    m = _Net(net, params, prec, fl, None)
    lqs = x.permute(0, 1, 4, 2, 3).float()
    n, t, c, h, w = lqs.shape
    feats_ = m.with_input_conv(lqs.reshape(-1, c, h, w), "feat_extract", 5)
    feats_ = feats_.view(n, t, -1, h, w)
    feats = {"spatial": [feats_[:, i] for i in range(t)]}
    lqs_1 = lqs[:, :-1].reshape(-1, c, h, w)
    lqs_2 = lqs[:, 1:].reshape(-1, c, h, w)
    flows_backward = m.spynet(lqs_1, lqs_2).view(n, t - 1, 2, h, w)
    flows_forward = m.spynet(lqs_2, lqs_1).view(n, t - 1, 2, h, w)
    for module in BRANCHES:
        m.propagate(feats, flows_backward if "backward" in module
                    else flows_forward, module)
    outs = [m.upsample(lqs[:, i], feats, i)
            for i in (range(t) if frames is None else frames)]
    return (torch.stack([o for o, _ in outs], 1),
            torch.stack([r for _, r in outs], 1))


def model_flops(net: dict, shape: tuple) -> int:
    """Operations a frame of one clip's forward at ``shape`` (B, T, H, W, C)
    (every frame's output), counted on the meta device from the layers
    above (convolutions and DCNs; the elementwise work, the warps and the
    sampling are not counted)."""
    params = {k: torch.empty(s, device="meta")
              for k, s, _, _ in param_specs(net)}
    fl = Flops()
    forward(net, params, torch.empty(shape, device="meta"), fl=fl)
    return fl.total // (shape[0] * shape[1])
