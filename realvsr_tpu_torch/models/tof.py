"""TOF (TOFlow-style VSR, ``torch.nn``, NHWC): SpyNet optical-flow
alignment of each neighbour to the centre frame, then an MSRResNet trunk
over the aligned frames (the reference's ``codes/models/archs/
TOF_arch.py``).

Counterpart of ``realvsr_tpu/models/tof.py`` under the same module names
(``align_arch.{k}.conv{i}`` / ``bn{i}``, ``sr_arch.*``).  SpyNet's 7x7
convs and BatchNorms go to cuDNN (``F.conv2d``, ``F.batch_norm``), its
warps to ``F.grid_sample`` (``ops/warp.py``); the trunk's 3x3 convs run
the conv3x3 kernel on the card (``models/srresnet.py``).  Each neighbour
runs SpyNet on its own, as in JAX: its BatchNorms take that call's batch
statistics and, under ``updating_batch_stats``, move their running ones
once a neighbour.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from realvsr_tpu_torch.models.common import (BatchNorm2d, Conv2d,
                                             reset_parameters)
from realvsr_tpu_torch.models.srresnet import MSRResNet
from realvsr_tpu_torch.ops.warp import flow_warp


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(2, 2, count_include_pad=False) on NHWC: on the even sizes
    SpyNet takes, the mean of each 2x2 block."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _upsample2x_align_corners(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsample, align_corners=True, on NHWC."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                         mode="bilinear", align_corners=True
                         ).permute(0, 2, 3, 1)


class SpyNetBlock(nn.Module):
    """Four 7x7 conv-BN-ReLU layers (32, 64, 32, 16) and a 7x7 conv to a
    2-channel flow refinement (TOF_arch.py:10-37); 0.1-scaled kaiming
    init."""

    def __init__(self, cin: int):
        super().__init__()
        widths = [32, 64, 32, 16]
        for i, w in enumerate(widths):
            setattr(self, f"conv{i}", Conv2d(cin, w, 7, init="residual"))
            setattr(self, f"bn{i}", BatchNorm2d(w))
            cin = w
        self.conv4 = Conv2d(cin, 2, 7, init="residual")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return self.conv4(x)


class SpyNet(nn.ModuleList):
    """K-level coarse-to-fine optical flow (TOF_arch.py:40-88): blocks
    ``0`` .. ``K``.  ``forward(ref, nbr)`` -> (nbr warped to ref, flow);
    the sizes must divide by 2^K."""

    def __init__(self, K: int = 3, in_nc: int = 3):
        super().__init__([SpyNetBlock(2 * in_nc)]
                         + [SpyNetBlock(2 * in_nc + 2) for _ in range(K)])
        self.K = K

    def forward(self, ref: torch.Tensor, nbr: torch.Tensor):
        h, w = ref.shape[1:3]
        if h % 2 ** self.K or w % 2 ** self.K:
            raise ValueError(f"SpyNet with K={self.K} takes sizes that "
                             f"divide by {2 ** self.K}, got {h}x{w}")
        refs, nbrs = [ref], [nbr]
        for _ in range(self.K):
            refs.insert(0, _avg_pool2(refs[0]))
            nbrs.insert(0, _avg_pool2(nbrs[0]))
        flow = self[0](torch.cat([refs[0], nbrs[0]], -1))
        for i in range(self.K):
            flow_up = _upsample2x_align_corners(flow) * 2.0
            warped = flow_warp(nbrs[i + 1], flow_up)
            flow = flow_up + self[i + 1](
                torch.cat([refs[i + 1], warped, flow_up], -1))
        return flow_warp(nbrs[-1], flow), flow


class TOF(nn.Module):
    """``forward(x)``: (B, N, H, W, C) window -> (B, H*upscale,
    W*upscale, out_nc) in the compute dtype (TOF_arch.py:148-189).

    Weights are drawn on the CPU from ``generator``, moved to ``device``
    and kept in f32; ``dtype`` is the compute dtype, as in the other
    generators.  BatchNorm (SpyNet's) follows ``train()`` / ``eval()``.
    """

    def __init__(self, nframes: int = 3, K: int = 3, in_nc: int = 3,
                 out_nc: int = 3, nf: int = 32, nb: int = 12,
                 upscale: int = 2, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nframes, self.dtype = nframes, dtype
        self.align_arch = SpyNet(K, in_nc)
        self.sr_arch = MSRResNet(nframes * in_nc, out_nc, nf, nb, upscale,
                                 device=None, dtype=dtype)
        reset_parameters(self, generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        if t != self.nframes:
            raise ValueError(f"TOF takes {self.nframes} frames, got {t}")
        x = x.to(self.dtype)
        ref = x[:, t // 2]
        aligned = [ref if i == t // 2 else self.align_arch(ref, x[:, i])[0]
                   for i in range(t)]
        return self.sr_arch(torch.cat(aligned, -1))
