"""Shared architecture blocks (``torch.nn``, NHWC activations).

Counterparts of ``realvsr_tpu/models/common.py``: the reference's
``arch_util.py`` blocks (with the pixel-shuffle ``Upsampler`` and the 3x3 /
stride 2 pools of TSA) and the DCN "Pack" module.  Parameters keep the
reference torch names and layouts (``weight`` OIHW, ``bias``), so
``load_state_dict(strict=True)`` takes reference ``.pth`` files and
:func:`realvsr_tpu_torch.convert.state_dict_from_jax` output alike.

Activations are channels-last ``(B, H, W, C)`` tensors.  Parameters are cast
to the activations' dtype where they are used, as the JAX package's modules
cast their f32 parameters to ``dtype`` at the call site: f32 parameters with
bf16 activations compute in bf16 and get f32 gradients (mixed precision),
and parameters already in the activations' dtype are used as they are.
Initialisers match the JAX package's torch-semantics ones and draw from an
explicit ``torch.Generator`` (:meth:`reset_parameters`):

  * Conv2d default: U(±1/sqrt(fan_in)) for weight and bias,
  * residual blocks: kaiming_normal(fan_in) scaled by 0.1, zero bias,
  * DCN offset/mask convs: zero; the DCN weight U(±1/sqrt(cin*9)), zero bias.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from realvsr_tpu_torch.ops.deform_conv import apply_act, modulated_deform_conv
from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3_autograd
from realvsr_tpu_torch.ops.resize import pixel_shuffle


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator | None):
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator | None):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


class Conv2d(nn.Module):
    """``nn.Conv2d(cin, cout, k, stride, padding, bias=bias)`` on NHWC
    tensors, with an optional fused activation, residual (added after the
    activation) and a second input concatenated on the channels (``x2``).
    ``bias=False`` is the JAX ``use_bias=False``: no ``bias`` parameter.

    ``kernel=True`` marks a 3x3 / stride 1 conv that runs the hand-written
    kernel (:func:`realvsr_tpu_torch.ops.kernels.conv3x3.conv3x3_autograd`)
    on a CUDA tensor at any ``cout`` (``cin`` a multiple of 16), as the JAX
    package runs ``conv3x3_packed`` / ``conv3x3_fused`` there; the other
    convs go to ``F.conv2d``, as the JAX package leaves them to XLA.
    """

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int | None = None,
                 act: str | None = None, kernel: bool = False,
                 init: str = "default", bias: bool = True):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2 if padding is None else padding
        self.act = act
        self.kernel = kernel
        self.init = init
        if kernel and (kernel_size, stride, self.padding) != (3, 1, 1):
            raise ValueError("the conv3x3 kernel takes 3x3 / stride 1 / pad 1")
        self.weight = nn.Parameter(
            torch.empty(cout, cin, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout)) if bias else None

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        fan_in = self.weight[0].numel()
        if self.init == "default":
            _uniform_(self.weight, 1 / math.sqrt(fan_in), gen)
            if self.bias is not None:
                _uniform_(self.bias, 1 / math.sqrt(fan_in), gen)
        elif self.init == "residual":  # kaiming_normal(fan_in) * 0.1
            _normal_(self.weight, math.sqrt(2.0 / fan_in) * 0.1, gen)
            nn.init.zeros_(self.bias)
        elif self.init == "zeros":
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)
        else:
            raise ValueError(f"unknown init {self.init!r}")

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                x2: torch.Tensor | None = None) -> torch.Tensor:
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.kernel:
            return conv3x3_autograd(x, weight, bias, self.act, residual, x2)
        xin = x if x2 is None else torch.cat([x, x2], dim=-1)
        y = F.conv2d(xin.permute(0, 3, 1, 2), weight, bias, self.stride,
                     self.padding)
        y = apply_act(y, self.act).permute(0, 2, 3, 1)
        if residual is not None:
            y = y + residual
        return y.contiguous()


class FrameSumConv1x1(nn.Module):
    """The EDVR woTSA fusion: a 1x1 conv over the frame-concatenated channels
    (EDVR_arch.py:344-353), channel order ``n * C + c``.

    (B, N, H, W, nf) → (B, H, W, nf); parameter ``weight`` is
    (nf, N*nf, 1, 1), as the reference's ``tsa_fusion`` conv.
    """

    def __init__(self, nframes: int, nf: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(nf, nframes * nf, 1, 1))
        self.bias = nn.Parameter(torch.empty(nf))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        bound = 1 / math.sqrt(self.weight.shape[1])
        _uniform_(self.weight, bound, gen)
        _uniform_(self.bias, bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, h, w, c = x.shape
        xc = x.permute(0, 2, 3, 1, 4).reshape(b * h * w, n * c)
        wt = self.weight.reshape(self.weight.shape[0], n * c).to(x.dtype)
        out = F.linear(xc, wt, self.bias.to(x.dtype))
        return out.reshape(b, h, w, -1)


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv + identity (arch_util.py:121-139), 0.1-scaled init.
    Both convs run the conv3x3 kernel; relu and the identity add fuse into
    its epilogues."""

    def __init__(self, nf: int = 64):
        super().__init__()
        self.conv1 = Conv2d(nf, nf, act="relu", kernel=True, init="residual")
        self.conv2 = Conv2d(nf, nf, kernel=True, init="residual")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x), residual=x)


class Blocks(nn.Sequential):
    """A stack of ``num`` residual blocks (the reference's ``make_layer``;
    keys ``<name>.<i>.conv1.weight``)."""

    def __init__(self, nf: int, num: int):
        super().__init__(*[ResidualBlockNoBN(nf) for _ in range(num)])


class DCNPack(nn.Module):
    """ModulatedDeformConvPack (dcn/deform_conv.py:257-292) in the PCD-align
    mode: offsets and masks are predicted from a separate feature tensor.

    ``conv_offset_mask`` (zero-initialised, on the conv3x3 kernel) gives
    3*dg*9 channels split into o1, o2, mask; offset = concat(o1, o2) in the
    (dg, tap, (dy, dx)) layout, mask through the sigmoid.  ``max_offset``
    clamps the offsets (None: exact).
    """

    def __init__(self, cin: int, cout: int, deformable_groups: int = 8,
                 max_offset: float | None = None):
        super().__init__()
        self.deformable_groups = deformable_groups
        self.max_offset = max_offset
        self.conv_offset_mask = Conv2d(cin, deformable_groups * 27, 3,
                                       kernel=True, init="zeros")
        self.weight = nn.Parameter(torch.empty(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _uniform_(self.weight, 1 / math.sqrt(self.weight[0].numel()), gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, offset_feat: torch.Tensor,
                act: str | None = None) -> torch.Tensor:
        o1, o2, m = torch.chunk(self.conv_offset_mask(offset_feat), 3, dim=-1)
        offset = torch.cat([o1, o2], dim=-1)
        mask = torch.sigmoid(m).contiguous()
        return modulated_deform_conv(
            x, offset, mask, self.weight.to(x.dtype), self.bias.to(x.dtype),
            deformable_groups=self.deformable_groups,
            max_offset=self.max_offset, act=act)


class Upsampler(nn.Module):
    """Pixel-shuffle upsampler (arch_util.py:142-165): for a scale 2^n, n
    times a 3x3 conv to 4 * n_feat channels then a x2 pixel shuffle; for 3,
    one conv to 9 * n_feat then x3; scale 1 is the identity.  Convs
    ``conv{i}``, on the conv3x3 kernel."""

    def __init__(self, scale: int, n_feat: int):
        super().__init__()
        if scale & (scale - 1) == 0:
            self.steps = [(4, 2)] * int(math.log2(scale))
        elif scale == 3:
            self.steps = [(9, 3)]
        else:
            raise NotImplementedError(f"scale {scale}")
        for i, (mult, _) in enumerate(self.steps):
            setattr(self, f"conv{i}", Conv2d(n_feat, mult * n_feat,
                                             kernel=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, (_, r) in enumerate(self.steps):
            x = pixel_shuffle(getattr(self, f"conv{i}")(x), r)
        return x


def _nchw_pool(pool, x: torch.Tensor) -> torch.Tensor:
    return pool(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1) \
        .contiguous()


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch MaxPool2d(3, stride=2, padding=1) on NHWC: -inf padding."""
    return _nchw_pool(F.max_pool2d, x)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch AvgPool2d(3, stride=2, padding=1) on NHWC,
    count_include_pad=True."""
    return _nchw_pool(F.avg_pool2d, x)


def reset_parameters(model: nn.Module, gen: torch.Generator | None) -> None:
    """Initialise every block of ``model`` in module order from ``gen``."""
    for m in model.modules():
        if hasattr(m, "reset_parameters") and m is not model:
            m.reset_parameters(gen)
