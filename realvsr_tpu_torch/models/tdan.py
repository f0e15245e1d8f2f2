"""TDAN, the Temporally Deformable Alignment Network (``torch.nn``, NHWC).

Counterpart of ``realvsr_tpu/models/tdan.py`` (``Align``, ``Trunk``,
``TDAN``), which rebuilds the reference ``TDAN_arch.py``.  As there, the
per-neighbour alignment loop is batched over the frames: the reference
frame's features are broadcast and all T frames run through the 4 chained
DCNs at once.  Module names are the reference's, so reference ``.pth``
state dicts and :func:`~realvsr_tpu_torch.convert.state_dict_from_jax`
output load unchanged.

On a CUDA tensor the 64-out 3x3 convs (the ResBlocks of both halves,
``bottle_neck`` with the reference and neighbour features as the kernel's
two input pointers, the four offset convs) and the other-width ones
(``reconstruction`` and ``final_conv``, 64 -> 3, and the DCNs'
``conv_offset_mask``, 64 -> 216) run the hand-written conv3x3 kernel, and
the 4 DCNs the DCN kernel, clamped to ±``dcn_max_offset`` as EDVR's are.
``initial_conv`` (3 input channels) and ``feature_extractor`` (3 frames x
3) go to ``F.conv2d``, as in EDVR.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from realvsr_tpu_torch.models.common import (Blocks, Conv2d, DCNPack,
                                             Upsampler, reset_parameters)


class Align(nn.Module):
    """4 chained DCNs per neighbour frame -> aligned image
    (TDAN_arch.py:17-72).

    Reference quirk, kept: ``residual_layers`` are ResBlocks of 64 channels
    whatever ``nf`` is (TDAN_arch.py:23), so the model runs only at nf 64.
    """

    def __init__(self, channel: int = 3, nf: int = 64, nb: int = 5,
                 groups: int = 8, max_offset: float | None = None):
        super().__init__()
        self.nf = nf
        self.initial_conv = Conv2d(channel, nf, act="relu")
        self.residual_layers = Blocks(64, nb)
        self.bottle_neck = Conv2d(2 * nf, nf, kernel=True)

        def off():
            return Conv2d(nf, nf, kernel=True)

        def dcn():
            return DCNPack(nf, nf, groups, max_offset)

        self.offset_conv_1 = off()
        self.deform_conv_1 = dcn()
        self.offset_conv_2 = off()
        self.deform_conv_2 = dcn()
        self.offset_conv_3 = off()
        self.deform_conv_3 = dcn()
        self.offset_conv = off()
        self.deform_conv = dcn()
        self.reconstruction = Conv2d(nf, channel, kernel=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, T, H, W, C) -> (B, H, W, T*C), frames concatenated on
        the channels (TDAN_arch.py:71)."""
        b, t, h, w, c = x.shape
        nbr = self.residual_layers(self.initial_conv(x.reshape(b * t, h, w,
                                                               c)))
        # the reference frame broadcast over the frames; a copy: the kernels
        # take contiguous inputs
        ref = nbr.reshape(b, t, h, w, self.nf)[:, t // 2:t // 2 + 1] \
            .expand(b, t, h, w, self.nf).reshape(nbr.shape).contiguous()
        fea = self.bottle_neck(ref, x2=nbr)
        fea = self.deform_conv_1(fea, self.offset_conv_1(fea))
        fea = self.deform_conv_2(fea, self.offset_conv_2(fea))
        fea = self.deform_conv_3(nbr, self.offset_conv_3(fea))
        aligned = self.deform_conv(fea, self.offset_conv(fea))
        im = self.reconstruction(aligned)
        return im.reshape(b, t, h, w, -1).permute(0, 2, 3, 1, 4) \
            .reshape(b, h, w, -1)


class Trunk(nn.Module):
    """Aligned frames -> ResBlocks -> Upsampler -> image
    (TDAN_arch.py:75-93); ``final_conv`` has no bias."""

    def __init__(self, channel: int = 3, nframes: int = 5, scale: int = 4,
                 nb: int = 10):
        super().__init__()
        self.feature_extractor = Conv2d(nframes * channel, 64, act="relu")
        self.residual_layers = Blocks(64, nb)
        self.upsampler = Upsampler(scale, 64)
        self.final_conv = Conv2d(64, 3, kernel=True, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.residual_layers(self.feature_extractor(x))
        return self.final_conv(self.upsampler(out))


class TDAN(nn.Module):
    """``forward(x)``: (B, N, H, W, C) window -> (B, H*scale, W*scale, 3),
    in the compute dtype.

    Weights are drawn on the CPU from ``generator``, moved to ``device`` and
    kept in f32; ``dtype`` is the compute dtype (the window is cast to it on
    entry, the parameters where they are used), as in
    :class:`~realvsr_tpu_torch.models.edvr.EDVRNoUp`.  ``dcn_max_offset``:
    None for the exact DCN, R to clamp the offsets to ±R.
    """

    def __init__(self, channel: int = 3, nframes: int = 5, scale: int = 4,
                 nf: int = 64, nb_f: int = 5, nb_b: int = 10, groups: int = 8,
                 dcn_max_offset: float | None = None, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.align = Align(channel, nf, nb_f, groups, dcn_max_offset)
        self.trunk = Trunk(channel, nframes, scale, nb_b)
        self.dtype = dtype
        reset_parameters(self, generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(self.align(x.to(self.dtype)))
