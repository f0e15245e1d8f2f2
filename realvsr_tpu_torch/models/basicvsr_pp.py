"""BasicVSR++ (``torch.nn``, NHWC): recurrent x4 video super-resolution
with second-order grid propagation and flow-guided deformable alignment
(Chan et al., CVPR 2022, arXiv:2104.13371; open-mmlab/mmediting's
``basicvsr_pp.py``, its ``SPyNet`` in ``basicvsr_net.py`` and
``SecondOrderDeformableAlignment``).

Module and parameter names are mmediting's (``spynet.basic_module.<l>.
basic_module.<i>.conv``, ``feat_extract.main.*``, ``deform_align.<branch>
.conv_offset.<i>``, ``backbone.<branch>.main.*``, ``reconstruction``,
``upsample1.upsample_conv``, ``conv_hr``, ``conv_last``), so its state
dict loads with ``strict=True``.

The model takes a whole clip: frame t's output needs the backward
branches over every later frame.  :meth:`BasicVSRPlusPlus.forward` runs it
whole; the restore entry (``eval/recurrent.py``) runs its stages one by
one (:meth:`~BasicVSRPlusPlus.extract`, :meth:`~BasicVSRPlusPlus.
compute_flow`, :meth:`~BasicVSRPlusPlus.propagate` per branch,
:meth:`~BasicVSRPlusPlus.reconstruct` per frame), and may hand
``propagate`` its own runner of a branch step, which calls the step's two
segments (:meth:`~BasicVSRPlusPlus.align_input`, :meth:`~BasicVSRPlusPlus.
backbone_step`) and the DCN between them apart.  As in mmediting,
``feat_extract`` runs over all frames at once and SPyNet over all frame
pairs of a direction in one batched call.

On a CUDA tensor the 3x3 convs whose input width is a multiple of 16 run
the hand-written conv3x3 kernel (the residual blocks, the backbones' and
``reconstruction``'s input convs at 128 / 192 / 256 / 320 -> 64, the
offset convs after the first, the 64 -> 256 pixel-shuffle convs with
their LeakyReLU fused (it commutes with the shuffle), ``conv_hr`` and
``conv_last`` with the bilinear x4 base as its fused residual); the first
offset conv (3 x 64 + 4 = 196 inputs), ``feat_extract``'s 3 -> 64 and
SPyNet's 7x7 convs go to ``F.conv2d``.  The alignment's DCNv2 (128 -> 64
in 16 deformable groups, exact offsets) runs the DCN kernel
(``csrc/dcn_narrow.cu``) on an offset / mask tensor laid out as DCNPack's.
Warps are :func:`~realvsr_tpu_torch.ops.warp.flow_warp` (float32
``grid_sample``).  Flows stay in float32 (two channels a pixel), the
features in the compute dtype.

Not carried over: ``cpu_cache`` (a 100-frame clip at 320x180 fits on the
card), the mirror-extended shortcut (the forward flows of a clip that
reads the same backwards are the backward ones reversed: computed here,
they come out the same), and ``is_low_res_input=False`` (raises).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from realvsr_tpu_torch.models.common import (Blocks, Conv2d, _uniform_,
                                             reset_parameters)
from realvsr_tpu_torch.models.tof import _avg_pool2, _upsample2x_align_corners
from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_om
from realvsr_tpu_torch.ops.resize import pixel_shuffle, resize_bilinear
from realvsr_tpu_torch.ops.warp import flow_warp

# the propagation branches, in the order they run and their features are
# concatenated
BRANCHES = ("backward_1", "forward_1", "backward_2", "forward_2")


class _ConvModule(nn.Module):
    """mmcv's ``ConvModule`` without a norm: a conv with its activation,
    under the key ``conv``."""

    def __init__(self, cin: int, cout: int, act: str | None):
        super().__init__()
        self.conv = Conv2d(cin, cout, 7, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class SPyNetBasicModule(nn.Module):
    """One level of SPyNet: five 7x7 convs 8 -> 32 -> 64 -> 32 -> 16 -> 2,
    ReLU after the first four (no BatchNorm, unlike TOF's blocks)."""

    def __init__(self):
        super().__init__()
        w = (8, 32, 64, 32, 16, 2)
        self.basic_module = nn.Sequential(*[
            _ConvModule(w[i], w[i + 1], "relu" if i < 4 else None)
            for i in range(5)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.basic_module(x)


class SPyNet(nn.Module):
    """Six-level coarse-to-fine optical flow.  ``forward(ref, supp)``: the
    flow (B, H, W, 2), (dx, dy), in float32, that warps ``supp`` onto
    ``ref``; any size, resized to multiples of 32 and back."""

    LEVELS = 6

    def __init__(self):
        super().__init__()
        self.basic_module = nn.ModuleList(
            SPyNetBasicModule() for _ in range(self.LEVELS))
        self.register_buffer(
            "mean", torch.tensor([0.485, 0.456, 0.406]).view(1, 3, 1, 1))
        self.register_buffer(
            "std", torch.tensor([0.229, 0.224, 0.225]).view(1, 3, 1, 1))

    def compute_flow(self, ref: torch.Tensor,
                     supp: torch.Tensor) -> torch.Tensor:
        mean, std = self.mean.reshape(3), self.std.reshape(3)
        ref, supp = [(ref - mean) / std], [(supp - mean) / std]
        for _ in range(self.LEVELS - 1):
            ref.insert(0, _avg_pool2(ref[0]))
            supp.insert(0, _avg_pool2(supp[0]))
        n, h, w, _ = ref[0].shape
        flow = ref[0].new_zeros(n, h, w, 2, dtype=torch.float32)
        for level, module in enumerate(self.basic_module):
            flow_up = (flow if level == 0
                       else _upsample2x_align_corners(flow) * 2.0)
            warped = flow_warp(supp[level], flow_up, padding_mode="border")
            flow = flow_up + module(torch.cat(
                [ref[level], warped, flow_up.to(warped.dtype)], -1))
        return flow

    def forward(self, ref: torch.Tensor, supp: torch.Tensor) -> torch.Tensor:
        h, w = ref.shape[1:3]
        h_up, w_up = -(-h // 32) * 32, -(-w // 32) * 32
        flow = self.compute_flow(resize_bilinear(ref, (h_up, w_up)),
                                 resize_bilinear(supp, (h_up, w_up)))
        flow = resize_bilinear(flow, (h, w))
        return torch.stack([flow[..., 0] * (w / w_up),
                            flow[..., 1] * (h / h_up)], -1)


class SecondOrderDeformableAlignment(nn.Module):
    """Flow-guided DCNv2 over two earlier frames' features.

    ``conv_offset`` maps the condition (3 x cout + the two flows) through
    three 3x3 convs with LeakyReLU(0.1) (fused; the ``Identity`` slots keep
    mmediting's indices) to 27 x dg channels: o1, o2 and the mask logits.
    The offsets are ``max_residue_magnitude`` x tanh(o1, o2), the first
    half (groups 0 .. dg/2 - 1, over ``x``'s first cin/2 channels) plus
    flow_1 and the second half plus flow_2, each flow flipped to (dy, dx)
    and repeated over its half's (group, tap) pairs; the DCN takes the
    mask's sigmoid.  Exact offsets: nothing is clamped.  :meth:`offsets`
    and :meth:`deform` are the two halves, which the propagation calls
    apart (``BasicVSRPlusPlus.step``)."""

    def __init__(self, cin: int, cout: int, deform_groups: int = 16,
                 max_residue_magnitude: float = 10):
        super().__init__()
        self.deform_groups = deform_groups
        self.max_residue_magnitude = max_residue_magnitude
        ccond = 3 * cout + 4
        self.conv_offset = nn.Sequential(
            Conv2d(ccond, cout, act="lrelu", kernel=ccond % 16 == 0),
            nn.Identity(),
            Conv2d(cout, cout, act="lrelu", kernel=True), nn.Identity(),
            Conv2d(cout, cout, act="lrelu", kernel=True), nn.Identity(),
            Conv2d(cout, 27 * deform_groups, kernel=True, init="zeros"))
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _uniform_(self.weight, self.weight[0].numel() ** -0.5, gen)
        nn.init.zeros_(self.bias)

    def offsets(self, cond: torch.Tensor, flow_1: torch.Tensor,
                flow_2: torch.Tensor) -> torch.Tensor:
        """The DCN's offset / mask tensor (B, H, W, 27 x dg), laid out as
        DCNPack's, from the condition and the two flows."""
        dt, dg = cond.dtype, self.deform_groups
        om = self.conv_offset(
            torch.cat([cond, flow_1.to(dt), flow_2.to(dt)], -1))
        b, h, w, _ = om.shape
        n = 18 * dg
        res = torch.tanh(om[..., :n]).mul_(self.max_residue_magnitude)
        flows = torch.stack([flow_1.flip(-1), flow_2.flip(-1)], 3)
        off = res.view(b, h, w, 2, n // 4, 2) + flows[:, :, :, :, None]
        return torch.cat([off.view(b, h, w, n).to(dt), om[..., n:]], -1)

    def deform(self, x: torch.Tensor, om: torch.Tensor) -> torch.Tensor:
        """The DCNv2 of ``x`` at :meth:`offsets`' ``om``."""
        dt = x.dtype
        return modulated_deform_conv_om(x, om, self.weight.to(dt),
                                        self.bias.to(dt), self.deform_groups)

    def forward(self, x: torch.Tensor, cond: torch.Tensor,
                flow_1: torch.Tensor, flow_2: torch.Tensor) -> torch.Tensor:
        return self.deform(x, self.offsets(cond, flow_1, flow_2))


class ResidualBlocksWithInputConv(nn.Module):
    """A 3x3 conv with LeakyReLU(0.1) (fused; ``main.1`` holds its slot),
    then ``num_blocks`` residual blocks."""

    def __init__(self, cin: int, cout: int = 64, num_blocks: int = 30):
        super().__init__()
        self.main = nn.Sequential(
            Conv2d(cin, cout, act="lrelu", kernel=cin % 16 == 0),
            nn.Identity(), Blocks(cout, num_blocks))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.main(x)


class PixelShufflePack(nn.Module):
    """A 3x3 conv to ``scale``² x cout channels and a pixel shuffle, with
    the LeakyReLU(0.1) that BasicVSR++ applies after it fused into the
    conv."""

    def __init__(self, cin: int, cout: int, scale: int):
        super().__init__()
        self.scale = scale
        self.upsample_conv = Conv2d(cin, cout * scale * scale, act="lrelu",
                                    kernel=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(self.upsample_conv(x), self.scale)


class BasicVSRPlusPlus(nn.Module):
    """``forward(lqs)``: (B, T, H, W, 3) low-resolution clip -> (B, T, 4H,
    4W, 3) in the compute dtype, H and W at least 64.

    Weights are drawn on the CPU from ``generator``, moved to ``device``
    and kept in f32 until the restore entry casts them to ``dtype``, the
    compute dtype, as the other generators.  SPyNet's weights are drawn
    like the rest (mmediting loads pretrained ones); the last offset conv
    of each alignment starts at zero, as in mmediting.  ``recurrent``
    tells the restore entry (``tools/_cli.py::restorer``) to run the model
    over whole clips (``eval/recurrent.py``) instead of a sliding window.
    """

    recurrent = True

    def __init__(self, mid_channels: int = 64, num_blocks: int = 7,
                 max_residue_magnitude: float = 10,
                 is_low_res_input: bool = True,
                 dcn_max_offset: float | None = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not is_low_res_input:
            raise NotImplementedError(
                "BasicVSR++ with is_low_res_input=False (x1 input) is not "
                "built")
        if dcn_max_offset is not None:
            raise ValueError("BasicVSR++'s DCN offsets carry the flow: they "
                             "are exact, not clamped")
        mid = mid_channels
        self.dtype = dtype
        self.spynet = SPyNet()
        self.feat_extract = ResidualBlocksWithInputConv(3, mid, 5)
        self.deform_align = nn.ModuleDict({
            m: SecondOrderDeformableAlignment(2 * mid, mid, 16,
                                              max_residue_magnitude)
            for m in BRANCHES})
        self.backbone = nn.ModuleDict({
            m: ResidualBlocksWithInputConv((2 + i) * mid, mid, num_blocks)
            for i, m in enumerate(BRANCHES)})
        self.reconstruction = ResidualBlocksWithInputConv(5 * mid, mid, 5)
        self.upsample1 = PixelShufflePack(mid, mid, 2)
        self.upsample2 = PixelShufflePack(mid, 64, 2)
        self.conv_hr = Conv2d(64, 64, act="lrelu", kernel=True)
        self.conv_last = Conv2d(64, 3, kernel=True)
        reset_parameters(self, generator)
        self.to(device=device)

    def extract(self, lqs: torch.Tensor) -> list[torch.Tensor]:
        """Each frame's features (B, H, W, mid), all frames in one call."""
        b, t, h, w, c = lqs.shape
        feats = self.feat_extract(lqs.reshape(b * t, h, w, c))
        feats = feats.view(b, t, h, w, -1)
        return [feats[:, i] for i in range(t)]

    def compute_flow(self, lqs: torch.Tensor):
        """(forward flows, backward flows), each (B, T - 1, H, W, 2) in
        float32: backward[i] warps frame i + 1 onto frame i, forward[i]
        frame i onto frame i + 1; one SPyNet call a direction."""
        b, t, h, w, c = lqs.shape
        if h < 64 or w < 64:
            raise ValueError(f"BasicVSR++ takes frames of at least 64x64, "
                             f"got {h}x{w}")
        l1 = lqs[:, :-1].reshape(-1, h, w, c)
        l2 = lqs[:, 1:].reshape(-1, h, w, c)
        backward = self.spynet(l1, l2).view(b, t - 1, h, w, 2)
        forward = self.spynet(l2, l1).view(b, t - 1, h, w, 2)
        return forward, backward

    def propagate(self, feats: dict, flows: torch.Tensor, module: str,
                  step=None) -> None:
        """Run branch ``module`` over the clip, adding ``feats[module]``:
        each frame's propagated features, in frame order.

        Each step is :meth:`step`, or ``step`` where given (a callable of
        the same arguments: the restore entry's graph runner,
        ``eval/recurrent.py``): segment A (:meth:`align_input`: the warps,
        the condition, the offsets), the alignment's DCN, then segment B
        (:meth:`backbone_step`: the backbone and its residual).  The first
        step has no alignment and the second no second order."""
        spatial = feats["spatial"]
        t = len(spatial)
        if module.startswith("backward"):
            frame_idx = flow_idx = range(t - 1, -1, -1)
        else:
            frame_idx, flow_idx = range(t), range(-1, t - 1)
        step = step or self.step
        earlier = [feats[k] for k in feats if k not in ("spatial", module)]
        out = []
        prop = spatial[0].new_zeros(spatial[0].shape)
        for i, idx in enumerate(frame_idx):
            flow_n1 = flows[:, flow_idx[i]] if i > 0 else None
            n2 = (out[-2], flows[:, flow_idx[i - 1]]) if i > 1 else ()
            prop = step(module, prop, spatial[idx],
                        [f[idx] for f in earlier], flow_n1, *n2)
            out.append(prop)
        feats[module] = out[::-1] if module.startswith("backward") else out

    def step(self, module: str, prop: torch.Tensor, current: torch.Tensor,
             others: list, flow_n1: torch.Tensor | None = None,
             feat_n2: torch.Tensor | None = None,
             flow_prev: torch.Tensor | None = None) -> torch.Tensor:
        """One step of branch ``module``: the frame's propagated features
        from the previous step's ``prop``, the frame's own features
        ``current`` and the earlier branches' at the frame (``others``).
        ``flow_n1`` (B, H, W, 2) warps the previous step's frame onto this
        one (None: the first step, no alignment); ``feat_n2`` is the output
        two steps back and ``flow_prev`` the flow before ``flow_n1`` (None:
        no second order)."""
        if flow_n1 is not None:
            x, om = self.align_input(module, prop, current, flow_n1, feat_n2,
                                     flow_prev)
            prop = self.deform_align[module].deform(x, om)
        return self.backbone_step(module, current, others, prop)

    def align_input(self, module: str, prop: torch.Tensor,
                    current: torch.Tensor, flow_n1: torch.Tensor,
                    feat_n2: torch.Tensor | None = None,
                    flow_prev: torch.Tensor | None = None):
        """Segment A of a step (:meth:`step`'s arguments): (the DCN's input
        ``cat([prop, feat_n2])``, its offset / mask tensor) from the three
        warps, the condition and branch ``module``'s offset convs."""
        cond_n1 = flow_warp(prop, flow_n1)
        if feat_n2 is None:     # no output two steps back yet
            feat_n2 = torch.zeros_like(prop)
            flow_n2 = torch.zeros_like(flow_n1)
            cond_n2 = torch.zeros_like(cond_n1)
        else:
            flow_n2 = flow_n1 + flow_warp(flow_prev, flow_n1)
            cond_n2 = flow_warp(feat_n2, flow_n2)
        cond = torch.cat([cond_n1, current, cond_n2], -1)
        om = self.deform_align[module].offsets(cond, flow_n1, flow_n2)
        return torch.cat([prop, feat_n2], -1), om

    def backbone_step(self, module: str, current: torch.Tensor,
                      others: list, prop: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
        """Segment B of a step: ``prop`` (the aligned features) plus branch
        ``module``'s backbone over ``cat([current, *others, prop])``,
        written into ``out`` where given."""
        feat = torch.cat([current, *others, prop], -1)
        return torch.add(prop, self.backbone[module](feat), out=out)

    def reconstruct(self, lq: torch.Tensor, feats: dict,
                    t: int) -> torch.Tensor:
        """Frame ``t``'s output (B, 4H, 4W, 3) from its five feature maps
        and its low-resolution frame ``lq`` (B, H, W, 3)."""
        hr = torch.cat([feats["spatial"][t]] + [feats[k][t]
                                                for k in BRANCHES], -1)
        hr = self.upsample2(self.upsample1(self.reconstruction(hr)))
        h, w = lq.shape[1:3]
        return self.conv_last(self.conv_hr(hr),
                              residual=resize_bilinear(lq, (4 * h, 4 * w)))

    def forward(self, lqs: torch.Tensor) -> torch.Tensor:
        lqs = lqs.to(self.dtype)
        feats = {"spatial": self.extract(lqs)}
        flows_forward, flows_backward = self.compute_flow(lqs)
        for module in BRANCHES:
            self.propagate(feats, flows_backward if module.startswith(
                "backward") else flows_forward, module)
        return torch.stack([self.reconstruct(lqs[:, t], feats, t)
                            for t in range(lqs.shape[1])], 1)
