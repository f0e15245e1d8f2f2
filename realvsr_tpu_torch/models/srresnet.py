"""MSRResNet (``torch.nn``, NHWC): the reference's
``codes/models/archs/SRResNet_arch.py`` and its multi-frame use in
``TOF_arch.py:91-145``.

Counterpart of ``realvsr_tpu/models/srresnet.py`` under the same module
names.  On a CUDA tensor the trunk's ResBlocks, ``upconv1`` / ``upconv2``
(lrelu fused: it commutes with the pixel shuffle after them), ``HRconv``
(lrelu fused) and ``conv_last`` (the bilinear base added as its fused
residual) run the hand-written conv3x3 kernel; ``conv_first`` (3 or 9
input channels) goes to ``F.conv2d``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from realvsr_tpu_torch.models.common import Blocks, Conv2d, reset_parameters
from realvsr_tpu_torch.ops.resize import pixel_shuffle, resize_bilinear


class MSRResNet(nn.Module):
    """conv_first -> ``nb`` ResBlocks -> pixel shuffle x ``upscale`` ->
    HRconv -> conv_last, plus the input resized bilinearly (for a
    multi-frame input of C > 3 channels, the centre frame's 3).

    ``forward(x)``: (B, H, W, in_nc) -> (B, H*upscale, W*upscale, out_nc)
    in the compute dtype ``dtype``.  The 0.1-scaled kaiming init of the
    convs outside the trunk holds only at x2 / x3 / x4 (TOF_arch.py:
    119-124); at x1 they keep torch's default.  ``device=None`` leaves
    the weights to an enclosing model's init (TOF).
    """

    def __init__(self, in_nc: int = 3, out_nc: int = 3, nf: int = 64,
                 nb: int = 16, upscale: int = 4, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        if upscale not in (1, 2, 3, 4):
            raise ValueError(f"upscale {upscale}")
        self.upscale, self.dtype = upscale, dtype
        init = "residual" if upscale in (2, 3, 4) else "default"
        self.conv_first = Conv2d(in_nc, nf, act="lrelu", init=init)
        self.recon_trunk = Blocks(nf, nb)
        if upscale == 4:
            self.upconv1 = Conv2d(nf, nf * 4, act="lrelu", kernel=True,
                                  init=init)
            self.upconv2 = Conv2d(nf, nf * 4, act="lrelu", kernel=True,
                                  init=init)
        elif upscale in (2, 3):
            self.upconv1 = Conv2d(nf, nf * upscale ** 2, act="lrelu",
                                  kernel=True, init=init)
        self.HRconv = Conv2d(nf, nf, act="lrelu", kernel=True, init=init)
        self.conv_last = Conv2d(nf, out_nc, kernel=True, init=init)
        if device is not None:
            reset_parameters(self, generator)
            self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        c = x.shape[-1]
        x_base = x[..., c // 2 - 1:c // 2 + 2] if c > 3 else x
        out = self.recon_trunk(self.conv_first(x))
        s = self.upscale
        if s == 4:
            out = pixel_shuffle(self.upconv1(out), 2)
            out = pixel_shuffle(self.upconv2(out), 2)
        elif s in (2, 3):
            out = pixel_shuffle(self.upconv1(out), s)
        h, w = x.shape[-3:-1]
        base = (x_base.contiguous() if s == 1
                else resize_bilinear(x_base, (h * s, w * s)))
        return self.conv_last(self.HRconv(out), residual=base)
