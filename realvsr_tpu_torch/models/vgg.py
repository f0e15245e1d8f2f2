"""VGG-style discriminators and the VGG19 feature extractor (``torch.nn``,
NHWC in and out): the reference's ``codes/models/archs/VGG_arch.py``.

Counterpart of ``realvsr_tpu/models/vgg.py`` under the same module names
(``conv{i}``, ``bn{i}``, ``conv{i}_{j}``, ``linear1``), so that
:func:`~realvsr_tpu_torch.convert.state_dict_from_jax` output loads with
``strict=True``.  The convs (up to 512 channels in) are ``F.conv2d`` on
channels-last views, cuDNN on the card, as ``eval/perceptual.py`` runs
VGG16 and as the JAX package leaves them to XLA.

No ImageNet weights ship with the repo: the feature extractor runs with
seeded random weights unless :func:`load_vgg19_weights` fills it from a
torchvision ``vgg19`` (or ``vgg19_bn``) state dict file, as the JAX
trainer does with ``path.vgg_weights``.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from realvsr_tpu_torch.models.common import (BatchNorm2d, Conv2d,
                                             lecun_normal_, reset_parameters)

# torchvision VGG19 conv plan: out channels of each conv, "M" a 2x2 max pool
_VGG19_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
               512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _normalise(x: torch.Tensor) -> torch.Tensor:
    """ImageNet normalisation on NHWC; a 1-channel input broadcasts against
    the 3 channels' mean and std into 3 channels, as in JAX."""
    mean = torch.tensor(_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(_IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _conv(conv: Conv2d, h: torch.Tensor) -> torch.Tensor:
    """``conv`` on an NCHW (channels-last) activation."""
    return F.conv2d(h, conv.weight.to(h.dtype),
                    None if conv.bias is None else conv.bias.to(h.dtype),
                    conv.stride, conv.padding)


def _bn_eval(bn: BatchNorm2d, h: torch.Tensor) -> torch.Tensor:
    return F.batch_norm(h, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def feature_plan(feature_layer: int, use_bn: bool) -> list[tuple]:
    """torchvision's ``vgg19(_bn).features[:feature_layer + 1]`` as steps
    ``("conv", i)``, ``("bn", i)``, ``("relu",)``, ``("pool",)``."""
    steps, idx, conv_i = [], 0, 0
    for item in _VGG19_PLAN:
        if idx > feature_layer:
            break
        if item == "M":
            steps.append(("pool",))
            idx += 1
            continue
        steps.append(("conv", conv_i))
        conv_i, idx = conv_i + 1, idx + 1
        if use_bn:
            if idx > feature_layer:
                break
            steps.append(("bn", conv_i - 1))
            idx += 1
        if idx > feature_layer:
            break
        steps.append(("relu",))
        idx += 1
    return steps


class VGGFeatureExtractor(nn.Module):
    """VGG19 ``features[:feature_layer + 1]`` on ImageNet-normalised input,
    frozen (VGG_arch.py:120-146): layer 34 is conv5_4 before its ReLU, 49
    the same with BN.  Always in eval mode (BN on running statistics, as
    the JAX module calls it); its parameters take no gradient, its input
    does."""

    def __init__(self, feature_layer: int = 34, use_bn: bool = False,
                 use_input_norm: bool = True, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_bn, self.use_input_norm, self.dtype = (use_bn,
                                                        use_input_norm, dtype)
        self.steps = feature_plan(feature_layer, use_bn)
        widths = [c for c in _VGG19_PLAN if c != "M"]
        cin = 3
        for step in self.steps:
            if step[0] == "conv":
                i = step[1]
                setattr(self, f"conv{i}", Conv2d(cin, widths[i], 3))
                cin = widths[i]
            elif step[0] == "bn":
                setattr(self, f"bn{step[1]}", BatchNorm2d(cin))
        reset_parameters(self, generator)
        self.requires_grad_(False)
        self.to(device=device).eval()

    def train(self, mode: bool = True):
        return super().train(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.use_input_norm:
            x = _normalise(x)
        h = x.permute(0, 3, 1, 2)
        for step in self.steps:
            if step[0] == "conv":
                h = _conv(getattr(self, f"conv{step[1]}"), h)
            elif step[0] == "bn":
                h = _bn_eval(getattr(self, f"bn{step[1]}"), h)
            elif step[0] == "relu":
                h = F.relu(h)
            else:
                h = F.max_pool2d(h, 2, 2)
        return h.permute(0, 2, 3, 1)


def load_vgg19_weights(model: VGGFeatureExtractor, torch_path: str) -> None:
    """Fill ``model`` in place from a torchvision ``vgg19`` state dict file
    (``features.{i}.weight`` / ``.bias``), or ``vgg19_bn``'s for a BN
    model (its conv, BN and running statistics)."""
    sd = torch.load(torch_path, map_location="cpu", weights_only=True)
    stride = 3 if model.use_bn else 2   # torchvision modules a conv takes
    idx, conv_i, loaded = 0, 0, {}
    for item in _VGG19_PLAN:
        if item == "M":
            idx += 1
            continue
        if hasattr(model, f"conv{conv_i}"):
            for leaf in ("weight", "bias"):
                loaded[f"conv{conv_i}.{leaf}"] = sd[f"features.{idx}.{leaf}"]
            if hasattr(model, f"bn{conv_i}"):
                for leaf in ("weight", "bias", "running_mean",
                             "running_var"):
                    loaded[f"bn{conv_i}.{leaf}"] = \
                        sd[f"features.{idx + 1}.{leaf}"]
        conv_i, idx = conv_i + 1, idx + stride
    model.load_state_dict(loaded, strict=False)
    missing = {k for k in model.state_dict()
               if not k.endswith("num_batches_tracked")} - set(loaded)
    if missing:
        raise KeyError(f"{torch_path} leaves {sorted(missing)} unfilled")


class Vgg19(nn.Module):
    """The 3-slice VGG19 feature pyramid (relu1_2, relu2_2, relu3_2),
    VGG_arch.py:149-184; returns the three, NHWC."""

    def __init__(self, use_input_norm: bool = True, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.use_input_norm, self.dtype = use_input_norm, dtype
        for i, (cin, cout) in enumerate([(3, 64), (64, 64), (64, 128),
                                         (128, 128), (128, 256),
                                         (256, 256)]):
            setattr(self, f"conv{i}", Conv2d(cin, cout, 3))
        reset_parameters(self, generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor):
        x = x.to(self.dtype)
        if self.use_input_norm:
            x = _normalise(x)
        h, outs = x.permute(0, 3, 1, 2), []
        for i in range(6):
            h = F.relu(_conv(getattr(self, f"conv{i}"), h))
            if i in (1, 3, 5):
                outs.append(h.permute(0, 2, 3, 1))
                if i < 5:
                    h = F.max_pool2d(h, 2, 2)
        return tuple(outs)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``weight`` (out, in) as torch's ``Linear``, LeCun
    normal init and zero bias."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.empty(cout))

    def reset_parameters(self, gen: torch.Generator | None = None) -> None:
        lecun_normal_(self.weight, self.weight.shape[1], gen)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class _DiscriminatorVGG(nn.Module):
    """Discriminator_VGG_128 / 192 (VGG_arch.py:8-117): 10 convs (the
    stride-2 4x4 ones halving the size five times), BN, then two Dense
    layers on the NCHW-flattened features.  Input (B, S, S, in_nc) with S
    = 32 * ``feat_hw``; output (B, 1) logits."""

    feat_hw = 4

    def __init__(self, in_nc: int = 3, nf: int = 64, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        self.conv0_0 = Conv2d(in_nc, nf, 3)
        self.conv0_1 = Conv2d(nf, nf, 4, 2, 1, bias=False)
        self.bn0_1 = BatchNorm2d(nf)
        cin = nf
        for i, mult in enumerate([2, 4, 8, 8], start=1):
            setattr(self, f"conv{i}_0", Conv2d(cin, nf * mult, 3, bias=False))
            setattr(self, f"bn{i}_0", BatchNorm2d(nf * mult))
            setattr(self, f"conv{i}_1",
                    Conv2d(nf * mult, nf * mult, 4, 2, 1, bias=False))
            setattr(self, f"bn{i}_1", BatchNorm2d(nf * mult))
            cin = nf * mult
        self.linear1 = Dense(cin * self.feat_hw ** 2, 100)
        self.linear2 = Dense(100, 1)
        reset_parameters(self, generator)
        self.to(device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fea = F.leaky_relu(self.conv0_0(x.to(self.dtype)), 0.2)
        fea = F.leaky_relu(self.bn0_1(self.conv0_1(fea)), 0.2)
        for i in range(1, 5):
            for j in (0, 1):
                fea = F.leaky_relu(getattr(self, f"bn{i}_{j}")(
                    getattr(self, f"conv{i}_{j}")(fea)), 0.2)
        b = fea.shape[0]
        if math.prod(fea.shape[1:3]) != self.feat_hw ** 2:
            raise ValueError(f"{type(self).__name__} takes "
                             f"{32 * self.feat_hw}^2 inputs")
        # torch flattens NCHW (channel major)
        fea = fea.permute(0, 3, 1, 2).reshape(b, -1)
        fea = F.leaky_relu(self.linear1(fea), 0.2)
        return self.linear2(fea)


class DiscriminatorVGG128(_DiscriminatorVGG):
    feat_hw = 4


class DiscriminatorVGG192(_DiscriminatorVGG):
    feat_hw = 6
