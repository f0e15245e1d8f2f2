"""EDVR_NoUp, the flagship VSR model (``torch.nn``, NHWC activations).

Counterpart of ``realvsr_tpu/models/edvr.py`` (``PCDAlign``'s plain branch
and ``EDVRNoUp``), which rebuilds the reference ``EDVR_arch.py``.  As there,
the per-frame PCD alignment loop is batched over the frames: neighbour
features are folded into the batch axis and the centre frame's pyramid is
broadcast as the reference.  Module names are the reference's, so reference
``.pth`` state dicts load unchanged.

On a CUDA tensor the 41 3x3 convs that the JAX package runs through its
Pallas conv kernel (10 front-chain, 10 PCD offset, 20 recon-trunk convs and
``HRconv``) run the hand-written conv3x3 kernel, and the 4 DCNs (L3, L2, L1,
cascade) the DCN kernel; the other convs go to ``F.conv2d`` as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from realvsr_tpu_torch.models.common import (
    Blocks, Conv2d, DCNPack, FrameSumConv1x1, reset_parameters)
from realvsr_tpu_torch.ops.resize import upsample2x_bilinear


class PCDAlign(nn.Module):
    """Pyramid-Cascading-Deformable alignment (EDVR_arch.py:62-132)."""

    def __init__(self, nf: int = 64, groups: int = 8,
                 max_offset: float | None = None):
        super().__init__()

        def off(cin):  # offset-conv chain link: 3x3 + lrelu on the kernel
            return Conv2d(cin, nf, act="lrelu", kernel=True)

        def dcn():
            return DCNPack(nf, nf, groups, max_offset)

        self.L3_offset_conv1 = off(2 * nf)
        self.L3_offset_conv2 = off(nf)
        self.L3_dcnpack = dcn()
        self.L2_offset_conv1 = off(2 * nf)
        self.L2_offset_conv2 = off(2 * nf)
        self.L2_offset_conv3 = off(nf)
        self.L2_dcnpack = dcn()
        self.L2_fea_conv = Conv2d(2 * nf, nf, act="lrelu")
        self.L1_offset_conv1 = off(2 * nf)
        self.L1_offset_conv2 = off(2 * nf)
        self.L1_offset_conv3 = off(nf)
        self.L1_dcnpack = dcn()
        self.L1_fea_conv = Conv2d(2 * nf, nf)
        self.cas_offset_conv1 = off(2 * nf)
        self.cas_offset_conv2 = off(nf)
        self.cas_dcnpack = dcn()

    def forward(self, nbr, ref):
        """nbr / ref: [L1, L2, L3] NHWC pyramids over the B*N frames."""
        # L3
        l3_off = self.L3_offset_conv1(nbr[2], x2=ref[2])
        l3_off = self.L3_offset_conv2(l3_off)
        l3_fea = self.L3_dcnpack(nbr[2], l3_off, act="lrelu")
        # L2 (the upsampled offsets are scaled x2 with the resolution)
        l2_off = self.L2_offset_conv1(nbr[1], x2=ref[1])
        l2_off = self.L2_offset_conv2(l2_off,
                                      x2=upsample2x_bilinear(l3_off) * 2)
        l2_off = self.L2_offset_conv3(l2_off)
        l2_fea = self.L2_dcnpack(nbr[1], l2_off)
        l2_fea = self.L2_fea_conv(l2_fea, x2=upsample2x_bilinear(l3_fea))
        # L1 (no activation after L1_fea_conv, as in the reference)
        l1_off = self.L1_offset_conv1(nbr[0], x2=ref[0])
        l1_off = self.L1_offset_conv2(l1_off,
                                      x2=upsample2x_bilinear(l2_off) * 2)
        l1_off = self.L1_offset_conv3(l1_off)
        l1_fea = self.L1_dcnpack(nbr[0], l1_off)
        l1_fea = self.L1_fea_conv(l1_fea, x2=upsample2x_bilinear(l2_fea))
        # cascading
        off = self.cas_offset_conv1(l1_fea, x2=ref[0])
        off = self.cas_offset_conv2(off)
        return self.cas_dcnpack(l1_fea, off, act="lrelu")


class EDVRNoUp(nn.Module):
    """x1 restoration variant, no upsampling (EDVR_arch.py:323-404), without
    TSA.  The model of all RealVSR experiments.

    ``forward(x, mode)``: "full" — (B, N, H, W, C) window → (B, H, W, C);
    "pyramid" — (B, H, W, C) frames → per-frame (L1, L2, L3) pyramid;
    "fuse" — (l1v, l2v, l3v, x_center) cached pyramids → frame.  The split
    modes give outputs identical to "full".

    Weights are drawn on the CPU from ``generator`` (so one seed gives the
    same model on every device), moved to ``device`` and kept in f32 (for
    inference :func:`~realvsr_tpu_torch.eval.sliding_window.make_forward`
    casts them to ``dtype`` once).
    ``dtype`` is the compute dtype: the window is cast to it on entry and the
    parameters where they are used, as the JAX package's ``dtype`` does, so
    bf16 computes in bf16 with f32 parameters and f32 gradients.  The
    centre frame added to the output is the window as given (a bf16 model
    fed f32 frames returns f32, as in JAX).
    ``dcn_max_offset``: None for the exact DCN, R to clamp the offsets to
    ±R as the JAX package's deployment setting does.
    """

    def __init__(self, nf: int = 64, nc: int = 3, nframes: int = 5,
                 groups: int = 8, front_RBs: int = 5, back_RBs: int = 10,
                 center: int | None = None, predeblur: bool = False,
                 HR_in: bool = False, w_TSA: bool = False,
                 dcn_max_offset: float | None = None, *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if predeblur or HR_in or w_TSA:
            raise NotImplementedError(
                "EDVRNoUp with predeblur, HR_in or TSA is not ported yet "
                "(ROADMAP, queue 1, item 3)")
        self.nframes = nframes
        self.center_idx = nframes // 2 if center is None else center
        self.conv_first = Conv2d(nc, nf, act="lrelu")
        self.feature_extraction = Blocks(nf, front_RBs)
        self.fea_L2_conv1 = Conv2d(nf, nf, 3, 2, act="lrelu")
        self.fea_L2_conv2 = Conv2d(nf, nf, act="lrelu")
        self.fea_L3_conv1 = Conv2d(nf, nf, 3, 2, act="lrelu")
        self.fea_L3_conv2 = Conv2d(nf, nf, act="lrelu")
        self.pcd_align = PCDAlign(nf, groups, dcn_max_offset)
        self.tsa_fusion = FrameSumConv1x1(nframes, nf)
        self.recon_trunk = Blocks(nf, back_RBs)
        self.HRconv = Conv2d(nf, 64, act="lrelu", kernel=True)
        self.conv_last = Conv2d(64, nc)
        self.dtype = dtype
        reset_parameters(self, generator)
        self.to(device=device)

    def front_pyramid(self, x_flat: torch.Tensor):
        """Per-frame 3-level feature pyramid, frames folded into the batch."""
        l1 = self.feature_extraction(self.conv_first(x_flat))
        l2 = self.fea_L2_conv2(self.fea_L2_conv1(l1))
        l3 = self.fea_L3_conv2(self.fea_L3_conv1(l2))
        return l1, l2, l3

    def align_fuse(self, l1v, l2v, l3v) -> torch.Tensor:
        """PCD alignment + fusion from stacked pyramids (B, N, h, w, nf)."""
        b, n, h, w, nf = l1v.shape
        ctr = self.center_idx
        nbr, ref = [], []
        for lv in (l1v, l2v, l3v):
            flat = (b * n,) + tuple(lv.shape[2:])
            nbr.append(lv.reshape(flat))
            # a copy: the kernels take contiguous inputs (at B=1 the
            # reshape of the broadcast would stay a stride-0 view)
            ref.append(lv[:, ctr:ctr + 1].expand(lv.shape).reshape(flat)
                       .contiguous())
        aligned = self.pcd_align(nbr, ref)
        return self.tsa_fusion(aligned.reshape(b, n, h, w, nf))

    def extract_and_align(self, x: torch.Tensor) -> torch.Tensor:
        b, n, h, w, c = x.shape
        l1, l2, l3 = self.front_pyramid(x.reshape(b * n, h, w, c))
        return self.align_fuse(l1.reshape(b, n, *l1.shape[1:]),
                               l2.reshape(b, n, *l2.shape[1:]),
                               l3.reshape(b, n, *l3.shape[1:]))

    def forward(self, x, mode: str = "full"):
        if mode == "pyramid":
            return self.front_pyramid(x.to(self.dtype))
        if mode == "fuse":
            l1v, l2v, l3v, x_center = x
            fea = self.align_fuse(l1v, l2v, l3v)
        elif mode == "full":
            x_center = x[:, self.center_idx]
            fea = self.extract_and_align(x.to(self.dtype))
        else:
            raise ValueError(f"unknown mode {mode!r}")
        out = self.HRconv(self.recon_trunk(fea))
        return self.conv_last(out) + x_center
