"""Shared architecture blocks (``torch.nn``, NHWC activations).

Counterparts of ``realvsr_tpu/models/common.py``: the reference's
``arch_util.py`` blocks (with the pixel-shuffle ``Upsampler``, the 3x3 /
stride 2 pools of TSA, the EDSR ``ResBlock`` and ``make_layer``) and the
DCN modules (``DCNPack``, ``DeformConvModule``).  Parameters keep the
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
  * residual blocks (and every ``scaled_kaiming_normal(0.1)`` conv of the
    JAX package): kaiming_normal(fan_in) scaled by 0.1, zero bias,
  * DCN offset/mask convs: zero; the DCN weight U(±1/sqrt(cin*9)), zero bias,
  * the discriminators' ``SimpleBlock``: torch ``init.orthogonal_`` on the
    (cout, cin*kh*kw) view (``orthogonal_hwio``), zero bias,
  * flax's own default (``nn.Dense``, ``nn.ConvTranspose``): LeCun normal
    (truncated at 2 std) and zero bias (:func:`lecun_normal_`).

:class:`BatchNorm2d` and :class:`PReLU` are the JAX package's
torch-semantics ``BatchNorm2d`` (running statistics updated only when asked,
:func:`updating_batch_stats`; under a process group, statistics of the
global batch) and ``PReLU``; :class:`ConvTranspose` is
``nn.ConvTranspose`` (2-D and 3-D) in torch's weight layout.
"""
from __future__ import annotations

import math
from contextlib import contextmanager

import torch
import torch.nn as nn
import torch.nn.functional as F

from realvsr_tpu_torch.ops.deform_conv import (apply_act, deform_conv,
                                               kernel_shape,
                                               modulated_deform_conv,
                                               modulated_deform_conv_om,
                                               split_om)
from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3_autograd
from realvsr_tpu_torch.ops.resize import pixel_shuffle
from realvsr_tpu_torch.parallel.mesh import all_reduce_sum, world_size


def lrelu(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    """LeakyReLU(0.1), the activation used across the reference archs."""
    return F.leaky_relu(x, slope)


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator | None):
    with torch.no_grad():
        t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


def _normal_(t: torch.Tensor, std: float, gen: torch.Generator | None):
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=gen) * std)


def _orthogonal_(t: torch.Tensor, gen: torch.Generator | None):
    """torch ``init.orthogonal_`` on the (cout, cin*kh*kw) view of an OIHW
    weight (the JAX package's ``orthogonal_hwio``)."""
    nn.init.orthogonal_(t.view(t.shape[0], -1), generator=gen)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  gen: torch.Generator | None) -> None:
    """flax's default kernel init: normal of variance 1/fan_in truncated at
    2 std (its std corrected for the truncation)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=gen)


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
        elif self.init == "orthogonal":
            _orthogonal_(self.weight, gen)
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


class ResBlock(nn.Module):
    """EDSR-style residual block (arch_util.py:97-118): conv-ReLU-conv, the
    result times ``res_scale`` added to the input; torch-default init.
    The convs are ``Conv2d_0`` and ``Conv2d_1``, the keys the JAX module's
    unnamed convs export under (``realvsr_tpu/train/torch_import.py``);
    at 3x3 with input widths the kernel takes (multiples of 16) they run
    the conv3x3 kernel, ReLU fused into the first."""

    def __init__(self, n_feats: int, kernel_size: int = 3,
                 res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        kernel = kernel_size == 3 and n_feats % 16 == 0
        self.Conv2d_0 = Conv2d(n_feats, n_feats, kernel_size, act="relu",
                               kernel=kernel)
        self.Conv2d_1 = Conv2d(n_feats, n_feats, kernel_size, kernel=kernel)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Conv2d_1(self.Conv2d_0(x))
        return x + out * self.res_scale


def make_layer(block_cls, n: int, **kwargs) -> nn.Sequential:
    """``n`` identical blocks in an ``nn.Sequential`` (arch_util.py:28-39;
    keys ``<i>.<...>``, as the JAX package's ``block<i>`` export)."""
    return nn.Sequential(*[block_cls(**kwargs) for _ in range(n)])


class DCNPack(nn.Module):
    """ModulatedDeformConvPack (dcn/deform_conv.py:257-292), the fields of
    ``realvsr_tpu/models/common.py::DCNPack``.

    ``conv_offset_mask`` (zero-initialised; ``kernel_size``, ``stride``,
    ``padding``) gives 3*dg*K channels (K = kernel_size^2) split into o1,
    o2, mask; offset = concat(o1, o2) in the (dg, tap, (dy, dx)) layout,
    mask through the sigmoid.  It reads ``offset_feat`` (the PCD-align mode,
    ``extra_offset_mask=True``, the default) or ``x`` itself
    (``extra_offset_mask=False``), ``cin`` channels wide either way.
    ``cout`` may differ from ``cin``; ``groups`` splits the conv.
    ``max_offset`` clamps the offsets (None: exact).

    At 3x3 / s1 / p1 / d1 / groups 1 (the default) the offset conv runs the
    conv3x3 kernel where its input width is a multiple of 16, and
    concat(o1, o2) is the first 2*dg*9 channels as they lie, so the DCN
    takes the tensor whole (:func:`~realvsr_tpu_torch.ops.deform_conv.
    modulated_deform_conv_om`): on the card the kernels read the offsets in
    place and take the sigmoid themselves, with no chunk, concat or sigmoid
    tensor.  Any other shape takes :func:`~realvsr_tpu_torch.ops.
    deform_conv.modulated_deform_conv` on the split (the plain op).
    Parameters: ``conv_offset_mask.{weight,bias}``, ``weight`` (cout, cin //
    groups, k, k), ``bias``.
    """

    def __init__(self, cin: int, cout: int, deformable_groups: int = 8,
                 max_offset: float | None = None, *, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 groups: int = 1, extra_offset_mask: bool = True):
        super().__init__()
        self.deformable_groups = deformable_groups
        self.max_offset = max_offset
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.extra_offset_mask = extra_offset_mask
        self.conv_offset_mask = Conv2d(
            cin, deformable_groups * 3 * kernel_size ** 2, kernel_size,
            stride, padding, init="zeros",
            kernel=(kernel_size, stride, padding) == (3, 1, 1)
            and cin % 16 == 0)
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _uniform_(self.weight, 1 / math.sqrt(self.weight[0].numel()), gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor,
                offset_feat: torch.Tensor | None = None,
                act: str | None = None) -> torch.Tensor:
        if self.extra_offset_mask and offset_feat is None:
            raise ValueError("DCNPack(extra_offset_mask=True) takes the "
                             "offset features as its second input")
        om = self.conv_offset_mask(offset_feat if self.extra_offset_mask
                                   else x)
        weight, bias = self.weight.to(x.dtype), self.bias.to(x.dtype)
        dg = self.deformable_groups
        if kernel_shape(weight, self.stride, self.padding, self.dilation,
                        self.groups):
            return modulated_deform_conv_om(x, om, weight, bias, dg,
                                            self.max_offset, act)
        return modulated_deform_conv(
            x, *split_om(om, dg), weight, bias, self.stride, self.padding,
            self.dilation, dg, self.max_offset, act, self.groups)


class DeformConvModule(nn.Module):
    """Unmodulated DeformConv (dcn/deform_conv.py:160-196,
    ``realvsr_tpu/models/common.py::DeformConvModule``): DCNv1 with the
    offsets given by the caller, no bias, padding 0 by default; parameter
    ``weight`` (cout, cin // groups, k, k), U(±1/sqrt(fan_in)).  At 3x3 /
    p1 it runs the DCN kernels on the card, elsewhere the plain op
    (:func:`~realvsr_tpu_torch.ops.deform_conv.deform_conv`)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 groups: int = 1, deformable_groups: int = 1):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.dilation, self.groups = dilation, groups
        self.deformable_groups = deformable_groups
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel_size, kernel_size))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        _uniform_(self.weight, 1 / math.sqrt(self.weight[0].numel()), gen)

    def forward(self, x: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
        return deform_conv(x, offset, self.weight.to(x.dtype), self.stride,
                           self.padding, self.dilation, self.groups,
                           self.deformable_groups)


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


class BatchNorm2d(nn.Module):
    """torch-semantics BatchNorm2d on NHWC tensors, with the JAX package's
    update rule (``realvsr_tpu/models/common.py::BatchNorm2d``).

    In train mode it normalises with the batch's biased statistics; in eval
    mode with the running ones.  The running statistics move (torch's rule:
    momentum 0.1, the unbiased variance) only inside
    :func:`updating_batch_stats`, as the JAX module writes them only when
    its ``batch_stats`` collection is mutable: a train-mode forward outside
    it leaves them as they are (the GAN step's discriminator forwards in
    the generator's step).  One ``F.batch_norm`` call, statistics in f32
    whatever the input's dtype, is the whole of it in a world of one
    process; under a process group a train-mode forward takes the global
    batch's statistics (:meth:`_global_batch_norm`).

    Parameters and buffers are ``nn.BatchNorm2d``'s (``weight``, ``bias``,
    ``running_mean``, ``running_var``, ``num_batches_tracked``); a state
    dict without ``num_batches_tracked`` (the JAX package's, which does not
    count) loads with ``strict=True`` and counts from 0.
    """

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.update_stats = False
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        with torch.no_grad():
            for t, v in ((self.weight, 1), (self.bias, 0),
                         (self.running_mean, 0), (self.running_var, 1),
                         (self.num_batches_tracked, 0)):
                t.fill_(v)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.setdefault(prefix + "num_batches_tracked",
                              torch.zeros_like(self.num_batches_tracked))
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        running = not self.training or self.update_stats
        if self.training and self.update_stats:
            self.num_batches_tracked += 1
        if self.training and world_size() > 1:
            return self._global_batch_norm(x)
        y = F.batch_norm(
            x.permute(0, 3, 1, 2), self.running_mean if running else None,
            self.running_var if running else None, self.weight, self.bias,
            self.training, self.momentum, self.eps)
        return y.permute(0, 2, 3, 1).contiguous()

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode under a process group: the statistics of the global
        batch, as JAX's BN takes them over a ``data``-sharded array (two
        passes, as ``jnp.var``): the per-channel sum, then the sum of
        squared deviations, each all-reduced with its gradient
        (``parallel/mesh.py::global_mean`` derives it).  The running
        statistics move from the global ones, identically on every rank."""
        xf = x.float()
        n = all_reduce_sum(xf.new_tensor(xf[..., 0].numel()))
        mean = all_reduce_sum(xf.sum((0, 1, 2))) / n
        var = all_reduce_sum(((xf - mean) ** 2).sum((0, 1, 2))) / n
        if self.update_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(
                    m * var * (n / (n - 1).clamp_min(1)))
        y = (xf - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias
        return y.to(x.dtype)


@contextmanager
def updating_batch_stats(model: nn.Module):
    """Inside, every :class:`BatchNorm2d` of ``model`` in train mode moves
    its running statistics (the JAX package's ``mutable=["batch_stats"]``
    apply)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.update_stats = True
    try:
        yield
    finally:
        for m in bns:
            m.update_stats = False


class PReLU(nn.Module):
    """torch ``nn.PReLU()``: one learned negative slope, init 0.25, named
    ``alpha`` as the JAX package names it."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((1,), 0.25))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        with torch.no_grad():
            self.alpha.fill_(0.25)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel = stride and no padding (the
    2-D upsamplers of the UNet discriminator, FSTRN's (1, s, s) 3-D one) on
    channels-first tensors: ``weight`` in torch's (cin, cout, *k) layout,
    which :func:`realvsr_tpu_torch.convert.state_dict_from_jax` fills from
    the flax kernel.  Init: flax's default (LeCun normal, zero bias), or
    U(±``bound``) for both where given."""

    def __init__(self, cin: int, cout: int, kernel: tuple[int, ...],
                 bound: float | None = None):
        super().__init__()
        self.kernel = tuple(kernel)
        self.bound = bound
        self.weight = nn.Parameter(torch.empty(cin, cout, *self.kernel))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        if self.bound is None:
            lecun_normal_(self.weight, self.weight.shape[0]
                          * math.prod(self.kernel), gen)
            nn.init.zeros_(self.bias)
        else:
            _uniform_(self.weight, self.bound, gen)
            _uniform_(self.bias, self.bound, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fn = (F.conv_transpose2d if len(self.kernel) == 2
              else F.conv_transpose3d)
        return fn(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                  stride=self.kernel)


def _nchw_pool(pool, x: torch.Tensor) -> torch.Tensor:
    # an NCHW copy, not the channels-last view of x: on CUDA (torch 2.11)
    # avg_pool2d's backward of a channels-last input with these
    # overlapping windows is wrong (86% of the gradient's largest), though
    # its forward is right; tests/test_torch_cuda.py holds both pools
    return pool(x.permute(0, 3, 1, 2).contiguous(), 3, 2, 1) \
        .permute(0, 2, 3, 1).contiguous()


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
