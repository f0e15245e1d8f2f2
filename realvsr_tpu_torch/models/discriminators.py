"""The discriminator zoo (``torch.nn``, NHWC): the reference's
``codes/models/archs/discriminator_arch.py``.

Counterpart of ``realvsr_tpu/models/discriminators.py``, module by module
and under the same names, so that
:func:`~realvsr_tpu_torch.convert.state_dict_from_jax` output loads with
``strict=True``.  Every multiscale variant returns a list of patch logits;
v3 / v4 take a list of pyramid levels (the GAN-Split step's HF levels),
the pyramid discriminators build theirs.  Norm layers are the
torch-semantics :class:`~realvsr_tpu_torch.models.common.BatchNorm2d`:
batch statistics in train mode, running ones in eval mode, the running
ones moved only under :func:`~realvsr_tpu_torch.models.common.
updating_batch_stats`.  As in the JAX package, the Gaussian and
image-gradient pyramid discriminators use the Gaussian pyramid (the
reference calls a ``util.gaussian_pyramid`` that does not exist).

The convs are 5x5 (Patch, Pixel), stride-2 3x3 and 2x2 transposed (UNet):
``F.conv2d`` / cuDNN on the card, as the JAX package leaves them to XLA; no
conv here is a 3x3 / stride 1 conv of the kernel's widths.

Each model casts its input(s) to ``dtype`` on entry and keeps f32
parameters; weights are drawn from ``generator`` on the CPU and moved to
``device``.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from realvsr_tpu_torch.models.common import (BatchNorm2d, Conv2d,
                                             ConvTranspose, reset_parameters)
from realvsr_tpu_torch.ops.pyramid import gau_pyramid, laplacian_pyramid


def _lrelu2(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class _Model(nn.Module):
    """Init, device and compute dtype of a discriminator; ``device=None``
    for one inside another, which the outer one initialises."""

    def _init(self, device, dtype, generator):
        self.dtype = dtype
        if device is not None:
            reset_parameters(self, generator)
            self.to(device=device)


class SimpleBlock(nn.Module):
    """conv-lrelu, (conv-BN-lrelu) x (depth - 2), conv; orthogonal init
    (discriminator_arch.py:13-40)."""

    def __init__(self, cin: int, depth: int = 3, n_channels: int = 64,
                 out_nc: int = 64, kernel_size: int = 3):
        super().__init__()
        self.depth = depth

        def conv(ci, co):
            return Conv2d(ci, co, kernel_size, init="orthogonal")

        self.conv0 = conv(cin, n_channels)
        for i in range(1, depth - 1):
            setattr(self, f"conv{i}", conv(n_channels, n_channels))
            setattr(self, f"bn{i}", BatchNorm2d(n_channels))
        setattr(self, f"conv{depth - 1}", conv(n_channels, out_nc))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _lrelu2(self.conv0(x))
        for i in range(1, self.depth - 1):
            x = _lrelu2(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return getattr(self, f"conv{self.depth - 1}")(x)


class PatchDiscriminator(_Model):
    """5x5 PatchGAN with stride-2 blocks (discriminator_arch.py:43-92);
    ``stride=1`` everywhere is the PixelDiscriminator (arch:95-144)."""

    down = 2

    def __init__(self, input_nc: int = 3, ndf: int = 64, n_block: int = 2,
                 kw: int = 5, padw: int = 2, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        strides, widths = [], []
        for n in range(n_block):
            mult = min(2 ** n, 8)
            strides += [self.down, 1]
            widths += [ndf * mult] * 2
        widths += [ndf * min(2 ** n_block, 8)] * 2
        strides += [1, 1]
        self.n_layers = len(widths)
        self.conv0 = Conv2d(input_nc, ndf, kw, 1, padw)
        cin = ndf
        for li, (w, s) in enumerate(zip(widths, strides), start=1):
            setattr(self, f"conv{li}", Conv2d(cin, w, kw, s, padw))
            setattr(self, f"bn{li}", BatchNorm2d(w))
            cin = w
        self.conv_out = Conv2d(cin, 1, kw, 1, padw)
        self._init(device, dtype, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _lrelu2(self.conv0(x.to(self.dtype)))
        for li in range(1, self.n_layers + 1):
            x = _lrelu2(getattr(self, f"bn{li}")(
                getattr(self, f"conv{li}")(x)))
        return self.conv_out(x)


class PixelDiscriminator(PatchDiscriminator):
    """The stride-1 variant (discriminator_arch.py:95-144)."""

    down = 1


class UNetDiscriminator(_Model):
    """U-Net discriminator (discriminator_arch.py:147-192): SimpleBlocks at
    three scales, stride-2 3x3 pools, 2x2 transposed-conv upsamplers and
    skip concatenations."""

    def __init__(self, in_nc: int = 3, nf: int = 64, depth: int = 2, *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()

        def sb(cin, ch, out):
            return SimpleBlock(cin, depth, ch, out)

        self.conv_block_s1 = sb(in_nc, nf, nf)
        self.pool1 = Conv2d(nf, 2 * nf, 3, 2)
        self.conv_block_s2 = sb(2 * nf, 2 * nf, 2 * nf)
        self.pool2 = Conv2d(2 * nf, 4 * nf, 3, 2)
        self.conv_block_s3 = sb(4 * nf, 4 * nf, 4 * nf)
        self.up1 = ConvTranspose(4 * nf, 2 * nf, (2, 2))
        self.conv_block_s4 = sb(4 * nf, 2 * nf, 2 * nf)
        self.up2 = ConvTranspose(2 * nf, nf, (2, 2))
        self.conv_block_s5 = sb(2 * nf, nf, 1)
        self._init(device, dtype, generator)

    @staticmethod
    def _up(conv: ConvTranspose, x: torch.Tensor) -> torch.Tensor:
        return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_s1 = self.conv_block_s1(x.to(self.dtype))
        x_s2 = self.conv_block_s2(self.pool1(x_s1))
        x_s3 = self.conv_block_s3(self.pool2(x_s2))
        out = torch.cat([self._up(self.up1, x_s3), x_s2], -1)
        out = self.conv_block_s4(out)
        out = torch.cat([self._up(self.up2, out), x_s1], -1)
        return self.conv_block_s5(out)


def _avg_pool_3x3_s2_nopad_count(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, 2, padding=1, count_include_pad=False) on NHWC, pooled
    on an NCHW copy: on CUDA (torch 2.11) avg_pool2d's backward of the
    channels-last view with these overlapping windows is wrong, as TSA's
    (``models/common.py::_nchw_pool``); tests/test_torch_cuda.py holds it."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 2, 1,
                        count_include_pad=False).permute(0, 2, 3, 1) \
        .contiguous()


class _Multiscale(_Model):
    """``num_D`` Patch (``gan_type='patch'``) or Pixel discriminators
    ``D_{num_D - 1}`` .. ``D_0``; input i goes to ``D_{num_D - 1 - i}``.
    ``varying``: D_j has ``n_block - j`` blocks (v1, v3), else all
    ``n_block``.  ``input_mult``: channels a D takes per image channel."""

    n_block_default = 2
    varying = False
    input_mult = 1

    def __init__(self, input_nc: int = 3, ndf: int = 64,
                 n_block: int | None = None, num_D: int = 3,
                 gan_type: str = "patch", *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.num_D = num_D
        n_block = self.n_block_default if n_block is None else n_block
        cls = PatchDiscriminator if gan_type == "patch" else PixelDiscriminator
        for j in range(num_D):
            blocks = n_block - j if self.varying else n_block
            setattr(self, f"D_{j}", cls(input_nc * self.input_mult, ndf,
                                        blocks, device=None, dtype=dtype))
        self._init(device, dtype, generator)

    def _run(self, inputs) -> list[torch.Tensor]:
        return [getattr(self, f"D_{self.num_D - 1 - i}")(x)
                for i, x in enumerate(inputs)]


class MultiscaleDiscriminatorV1(_Multiscale):
    """Ds of different depths, all on the same input (arch:195-219)."""

    n_block_default = 3
    varying = True

    def forward(self, x):
        return self._run([x] * self.num_D)


class MultiscaleDiscriminatorV2(_Multiscale):
    """Ds of one depth on a 3x3 / stride 2 average-pool cascade
    (arch:222-250)."""

    def forward(self, x):
        levels = [x]
        for _ in range(self.num_D - 1):
            levels.append(_avg_pool_3x3_s2_nopad_count(levels[-1]))
        return self._run(levels)


class MultiscaleDiscriminatorV3(_Multiscale):
    """Ds of different depths over a given list of pyramid levels
    (arch:253-278)."""

    n_block_default = 3
    varying = True

    def forward(self, inputs):
        if len(inputs) != self.num_D:
            raise ValueError(f"{len(inputs)} levels for {self.num_D} Ds")
        return self._run(inputs)


class MultiscaleDiscriminatorV4(_Multiscale):
    """Ds of one depth over a given list of pyramid levels (arch:281-305):
    the GAN-Split recipe's discriminator."""

    def forward(self, inputs):
        if len(inputs) != self.num_D:
            raise ValueError(f"{len(inputs)} levels for {self.num_D} Ds")
        return self._run(inputs)


class LaplacePyramidDiscriminator(_Multiscale):
    """Builds the Laplacian pyramid of its input (arch:308-339)."""

    def forward(self, x):
        return self._run(laplacian_pyramid(x, max_levels=self.num_D))


class GaussianPyramidDiscriminator(_Multiscale):
    """Builds the Gaussian pyramid of its input (arch:342-373)."""

    def forward(self, x):
        return self._run(gau_pyramid(x, max_levels=self.num_D))


class ImageGradientPyramidDiscriminatorV1(_Multiscale):
    """Each level's Gaussian and Laplacian images concatenated on the
    channels (arch:376-412); the Ds take twice the channels."""

    input_mult = 2

    def forward(self, x):
        return self._run([
            torch.cat([g, lp], -1) for g, lp in zip(
                gau_pyramid(x, max_levels=self.num_D),
                laplacian_pyramid(x, max_levels=self.num_D))])


class ImageGradientPyramidDiscriminatorV2(ImageGradientPyramidDiscriminatorV1):
    """Takes the two pyramids as lists (arch:415-438)."""

    def forward(self, gau_pyr, lap_pyr):
        if not len(gau_pyr) == len(lap_pyr) == self.num_D:
            raise ValueError(f"pyramids of {len(gau_pyr)} / {len(lap_pyr)} "
                             f"levels for {self.num_D} Ds")
        return self._run([torch.cat([g, lp], -1)
                          for g, lp in zip(gau_pyr, lap_pyr)])
