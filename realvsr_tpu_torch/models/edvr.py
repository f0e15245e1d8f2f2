"""EDVR_NoUp, the flagship VSR model, and the rest of the EDVR family
(``torch.nn``, NHWC activations).

Counterpart of ``realvsr_tpu/models/edvr.py`` (``PCDAlign``'s plain branch,
``TSAFusion``, ``PredeblurResNetPyramid``, ``EDVR`` and ``EDVRNoUp``), which
rebuilds the reference ``EDVR_arch.py``.  As there, the per-frame PCD
alignment loop is batched over the frames: neighbour features are folded
into the batch axis and the centre frame's pyramid is broadcast as the
reference.  Module names are the reference's, so reference ``.pth`` state
dicts load unchanged.

On a CUDA tensor the 41 3x3 convs of the flagship that the JAX package runs
through its Pallas conv kernel (10 front-chain, 10 PCD offset, 20
recon-trunk convs and ``HRconv``) run the hand-written conv3x3 kernel, and
the 4 DCNs (L3, L2, L1, cascade) the DCN kernel.  So do its other 3x3 /
stride 1 convs, where the kernel is faster than cuDNN (``PERF.md``): the
pyramid's ``fea_L2_conv2`` / ``fea_L3_conv2``, PCD's ``L2_fea_conv`` /
``L1_fea_conv`` (their concat as two input pointers), the DCNs'
``conv_offset_mask`` (64 -> 216) and ``conv_last`` (64 -> 3): 45 convs at
64 outputs and 5 at other widths per window.  ``conv_first`` (3 inputs) and
the stride-2 convs go to ``F.conv2d``, as the JAX package leaves them to
XLA.  The rest of the
family adds, on the kernel: TSA's 3x3 convs (``tAtt_1``, ``tAtt_2``,
``sAtt_L2`` with its concat as two input pointers, ``sAtt_L3``, ``sAtt_3``,
``sAtt_5``), the pre-deblur ResBlocks, and EDVR's ``upconv1`` / ``upconv2``
(64 -> 256) and ``conv_last`` (64 -> 3).
"""
from __future__ import annotations

import torch
import torch.nn as nn

from realvsr_tpu_torch.models.common import (
    Blocks, Conv2d, DCNPack, FrameSumConv1x1, ResidualBlockNoBN,
    avg_pool_3x3_s2, max_pool_3x3_s2, reset_parameters)
from realvsr_tpu_torch.ops.resize import (pixel_shuffle, resize_bilinear,
                                          upsample2x_bilinear)


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
        self.L2_fea_conv = Conv2d(2 * nf, nf, act="lrelu", kernel=True)
        self.L1_offset_conv1 = off(2 * nf)
        self.L1_offset_conv2 = off(2 * nf)
        self.L1_offset_conv3 = off(nf)
        self.L1_dcnpack = dcn()
        self.L1_fea_conv = Conv2d(2 * nf, nf, kernel=True)
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


class TSAFusion(nn.Module):
    """Temporal-Spatial Attention fusion (EDVR_arch.py:135-208):
    (B, N, H, W, nf) -> (B, H, W, nf).  The 3x3 convs run the conv3x3
    kernel on a CUDA tensor, the 1x1 convs ``F.conv2d``."""

    def __init__(self, nf: int = 64, nframes: int = 5, center: int = 2):
        super().__init__()
        self.center = center

        def conv3(cin=nf, act=None):
            return Conv2d(cin, nf, act=act, kernel=True)

        def conv1(cin=nf, act="lrelu"):
            return Conv2d(cin, nf, 1, act=act)

        self.tAtt_1 = conv3()
        self.tAtt_2 = conv3()
        self.fea_fusion = conv1(nframes * nf)
        self.sAtt_1 = conv1(nframes * nf)
        self.sAtt_2 = conv1(2 * nf)
        self.sAtt_3 = conv3(act="lrelu")
        self.sAtt_4 = conv1()
        self.sAtt_5 = conv3()
        self.sAtt_L1 = conv1()
        self.sAtt_L2 = conv3(2 * nf, "lrelu")
        self.sAtt_L3 = conv3(act="lrelu")
        self.sAtt_add_1 = conv1()
        self.sAtt_add_2 = conv1(act=None)

    def forward(self, aligned: torch.Tensor) -> torch.Tensor:
        b, n, h, w, c = aligned.shape
        # temporal attention: each frame's embedding against the centre's
        emb_ref = self.tAtt_2(aligned[:, self.center].contiguous())
        emb = self.tAtt_1(aligned.reshape(b * n, h, w, c)).reshape(
            b, n, h, w, -1)
        cor_prob = torch.sigmoid((emb * emb_ref[:, None]).sum(-1))[..., None]
        fea_w = (aligned * cor_prob).permute(0, 2, 3, 1, 4).reshape(
            b, h, w, n * c)
        fea = self.fea_fusion(fea_w)
        # spatial attention pyramid
        att = self.sAtt_1(fea_w)
        att = self.sAtt_2(torch.cat([max_pool_3x3_s2(att),
                                     avg_pool_3x3_s2(att)], dim=-1))
        att_l = self.sAtt_L1(att)
        att_l = self.sAtt_L2(max_pool_3x3_s2(att_l),
                             x2=avg_pool_3x3_s2(att_l))
        att_l = upsample2x_bilinear(self.sAtt_L3(att_l))
        att = self.sAtt_4(self.sAtt_3(att) + att_l)
        att = self.sAtt_5(upsample2x_bilinear(att))
        att_add = self.sAtt_add_2(self.sAtt_add_1(att))
        return fea * torch.sigmoid(att) * 2 + att_add


class PredeblurResNetPyramid(nn.Module):
    """Pre-deblur front end (EDVR_arch.py:15-59); ``HR_in`` takes frames at
    4x the working size down through two stride-2 convs."""

    def __init__(self, nf: int = 128, nc: int = 3, HR_in: bool = False):
        super().__init__()
        self.HR_in = HR_in
        if HR_in:
            self.conv_first_1 = Conv2d(nc, nf, act="lrelu")
            self.conv_first_2 = Conv2d(nf, nf, 3, 2, act="lrelu")
            self.conv_first_3 = Conv2d(nf, nf, 3, 2, act="lrelu")
        else:
            self.conv_first = Conv2d(nc, nf, act="lrelu")
        for name in ("RB_L1_1", "RB_L1_2", "RB_L1_3", "RB_L1_4", "RB_L1_5",
                     "RB_L2_1", "RB_L2_2", "RB_L3_1"):
            setattr(self, name, ResidualBlockNoBN(nf))
        self.deblur_L2_conv = Conv2d(nf, nf, 3, 2, act="lrelu")
        self.deblur_L3_conv = Conv2d(nf, nf, 3, 2, act="lrelu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.HR_in:
            l1 = self.conv_first_3(self.conv_first_2(self.conv_first_1(x)))
        else:
            l1 = self.conv_first(x)
        l2 = self.deblur_L2_conv(l1)
        l3 = self.deblur_L3_conv(l2)
        l3 = upsample2x_bilinear(self.RB_L3_1(l3))
        l2 = upsample2x_bilinear(self.RB_L2_2(self.RB_L2_1(l2) + l3))
        l1 = self.RB_L1_2(self.RB_L1_1(l1)) + l2
        return self.RB_L1_5(self.RB_L1_4(self.RB_L1_3(l1)))


class _EDVRBase(nn.Module):
    """Feature extraction, PCD alignment, fusion and the reconstruction
    trunk, shared by :class:`EDVRNoUp` and :class:`EDVR`; the subclasses add
    their heads (:meth:`head`).

    ``forward(x, mode)``: "full" — (B, N, H, W, C) window → frame;
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
                 HR_in: bool = False, w_TSA: bool = True,
                 dcn_max_offset: float | None = None, *,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nframes = nframes
        self.center_idx = nframes // 2 if center is None else center
        self.predeblur, self.HR_in = predeblur, HR_in
        if predeblur:
            self.pre_deblur = PredeblurResNetPyramid(nf, nc, HR_in)
            self.conv_1x1 = Conv2d(nf, nf, 1)
        elif HR_in:
            self.conv_first_1 = Conv2d(nc, nf, act="lrelu")
            self.conv_first_2 = Conv2d(nf, nf, 3, 2, act="lrelu")
            self.conv_first_3 = Conv2d(nf, nf, 3, 2, act="lrelu")
        else:
            self.conv_first = Conv2d(nc, nf, act="lrelu")
        self.feature_extraction = Blocks(nf, front_RBs)
        self.fea_L2_conv1 = Conv2d(nf, nf, 3, 2, act="lrelu")
        self.fea_L2_conv2 = Conv2d(nf, nf, act="lrelu", kernel=True)
        self.fea_L3_conv1 = Conv2d(nf, nf, 3, 2, act="lrelu")
        self.fea_L3_conv2 = Conv2d(nf, nf, act="lrelu", kernel=True)
        self.pcd_align = PCDAlign(nf, groups, dcn_max_offset)
        self.tsa_fusion = (TSAFusion(nf, nframes, self.center_idx) if w_TSA
                           else FrameSumConv1x1(nframes, nf))
        self.recon_trunk = Blocks(nf, back_RBs)
        self.dtype = dtype

    def _init(self, device, generator) -> None:
        reset_parameters(self, generator)
        self.to(device=device)

    def front_pyramid(self, x_flat: torch.Tensor):
        """Per-frame 3-level feature pyramid, frames folded into the batch."""
        if self.predeblur:
            l1 = self.conv_1x1(self.pre_deblur(x_flat))
        elif self.HR_in:
            l1 = self.conv_first_3(self.conv_first_2(self.conv_first_1(
                x_flat)))
        else:
            l1 = self.conv_first(x_flat)
        l1 = self.feature_extraction(l1)
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

    def head(self, fea: torch.Tensor, x_center: torch.Tensor):
        raise NotImplementedError

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
        return self.head(self.recon_trunk(fea), x_center)


class EDVRNoUp(_EDVRBase):
    """x1 restoration variant, no upsampling (EDVR_arch.py:323-404).  The
    model of all RealVSR experiments (without TSA, ``w_TSA=False``).

    Takes ``w_TSA`` and ``predeblur`` as the JAX class does.  ``HR_in``
    raises: the features come out at 1/4 of the centre frame they are added
    to, where the JAX class fails at that add.
    """

    def __init__(self, nf: int = 64, nc: int = 3, nframes: int = 5,
                 groups: int = 8, front_RBs: int = 5, back_RBs: int = 10,
                 center: int | None = None, predeblur: bool = False,
                 HR_in: bool = False, w_TSA: bool = False,
                 dcn_max_offset: float | None = None, *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        if HR_in:
            raise ValueError("EDVRNoUp with HR_in: its output is at 1/4 of "
                             "the centre frame it adds (the JAX class fails "
                             "there too); use EDVR")
        super().__init__(nf, nc, nframes, groups, front_RBs, back_RBs, center,
                         predeblur, HR_in, w_TSA, dcn_max_offset, dtype=dtype)
        self.HRconv = Conv2d(nf, 64, act="lrelu", kernel=True)
        self.conv_last = Conv2d(64, nc, kernel=True)
        self._init(device, generator)

    def head(self, fea, x_center):
        return self.conv_last(self.HRconv(fea)) + x_center


class EDVR(_EDVRBase):
    """EDVR with x4 pixel-shuffle upsampling (EDVR_arch.py:211-320): the
    output is (B, 4H, 4W, nc), the conv head plus the centre frame resized
    bilinearly x4 (or as given with ``HR_in``, whose input is at 4x).  The
    lrelu after each pixel shuffle fuses into the conv before it (an
    elementwise act commutes with the shuffle's permutation).
    """

    def __init__(self, nf: int = 64, nc: int = 3, nframes: int = 5,
                 groups: int = 8, front_RBs: int = 5, back_RBs: int = 10,
                 center: int | None = None, predeblur: bool = False,
                 HR_in: bool = False, w_TSA: bool = True,
                 dcn_max_offset: float | None = None, *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__(nf, nc, nframes, groups, front_RBs, back_RBs, center,
                         predeblur, HR_in, w_TSA, dcn_max_offset, dtype=dtype)
        self.upconv1 = Conv2d(nf, nf * 4, act="lrelu", kernel=True)
        self.upconv2 = Conv2d(nf, 64 * 4, act="lrelu", kernel=True)
        self.HRconv = Conv2d(64, 64, act="lrelu", kernel=True)
        self.conv_last = Conv2d(64, nc, kernel=True)
        self._init(device, generator)

    def head(self, fea, x_center):
        out = pixel_shuffle(self.upconv1(fea), 2)
        out = pixel_shuffle(self.upconv2(out), 2)
        out = self.conv_last(self.HRconv(out))
        if self.HR_in:
            return out + x_center
        h, w = x_center.shape[-3:-1]
        return out + resize_bilinear(x_center, (4 * h, 4 * w))
