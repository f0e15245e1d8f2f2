"""LPIPS (VGG16) and DISTS full-reference perceptual metrics.

Counterpart of ``realvsr_tpu/eval/perceptual.py``, which rebuilds the
metrics the reference computes with IQA_pytorch (LPIPSvgg / DISTS): a VGG16
feature backbone with the published metric heads, the same VGG16 plan,
stage taps (relu1_2 ... relu5_3), input normalisation and DISTS' Hanning
L2 pooling.  Inputs are NHWC RGB in [0, 1]; each metric returns per-image
(B,) scores.

The backbone is an ``nn.Module`` whose parameters carry torchvision's
names (``features.{i}.weight`` / ``.bias``), so a torchvision ``vgg16``
state dict loads into it with ``strict=True``.  Its convs are ``F.conv2d``
(cuDNN on the card), as the JAX package computes them with
``lax.conv_general_dilated`` and no Pallas kernel.

Metric parameters are a dict, as in JAX: ``{"vgg16": VGG16Features,
"lins": [(C_k,) x 5]}`` for LPIPS, ``{"vgg16", "alpha": [(C_k,) x 6],
"beta": [...]}`` for DISTS (stage 0 the raw input's 3 channels).
:func:`build_params` makes it from host tensors (the form of
``realvsr_tpu_torch.convert.perceptual_params_from_jax``);
:func:`init_lpips_params` draws the JAX package's random init (the same
numpy draws, so the same numbers); :func:`load_lpips_weights` /
:func:`load_dists_weights` read torch checkpoint files.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# torchvision VGG16 features: conv channels with 'M' pool markers; LPIPS /
# DISTS tap the (post-ReLU) stage outputs relu1_2 .. relu5_3
_VGG16_PLAN = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
               512, 512, 512, "M", 512, 512, 512]
_STAGE_CHNS = [64, 128, 256, 512, 512]

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def conv_indices() -> list[int]:
    """torchvision ``features`` indices of the 13 convs (each conv is
    followed by its ReLU, each 'M' is one pool module)."""
    idx, out = 0, []
    for item in _VGG16_PLAN:
        if item == "M":
            idx += 1
            continue
        out.append(idx)
        idx += 2
    return out


class VGG16Features(nn.Module):
    """torchvision ``vgg16().features`` up to relu5_3: ``features`` is an
    ``nn.Sequential`` of the 13 convs, their ReLUs and the 4 pools at
    torchvision's indices.  :meth:`forward` runs it with the pooling the
    metric asks for and returns the 5 stage outputs (NCHW)."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for item in _VGG16_PLAN:
            if item == "M":
                layers.append(nn.MaxPool2d(2, 2))
                continue
            layers += [nn.Conv2d(cin, item, 3, padding=1), nn.ReLU()]
            cin = item
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor, pool) -> list[torch.Tensor]:
        stages, h = [], x
        for layer in self.features:
            if isinstance(layer, nn.MaxPool2d):
                stages.append(h)
                h = pool(h)
            elif isinstance(layer, nn.Conv2d):
                h = F.relu(F.conv2d(h, layer.weight, layer.bias, padding=1))
        stages.append(h)  # relu5_3 (no trailing pool)
        return stages


def _max_pool2(x):
    return F.max_pool2d(x, 2, 2)


def _l2_pool(x, filter_size: int = 5, stride: int = 2):
    """DISTS L2pooling: depthwise Hanning-window pooling of x^2, then
    sqrt."""
    a = np.hanning(filter_size)[1:-1]
    g = (a[:, None] * a[None, :]).astype(np.float32)
    g = torch.from_numpy(g / g.sum()).to(x.device, x.dtype)
    c = x.shape[1]
    out = F.conv2d(x * x, g[None, None].expand(c, 1, -1, -1).contiguous(),
                   stride=stride, padding=(filter_size - 2) // 2, groups=c)
    return torch.sqrt(out + 1e-12)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC [0, 1] -> NCHW, normalised by the ImageNet mean and std."""
    mean = x.new_tensor(_MEAN)
    std = x.new_tensor(_STD)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def _as_input(x, params) -> torch.Tensor:
    """An NHWC batch (tensor or array) as f32 on the backbone's device."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(next(params["vgg16"].parameters()).device, torch.float32)


# --------------------------------------------------------------------- LPIPS
@torch.inference_mode()
def lpips(params: dict, x, y) -> torch.Tensor:
    """LPIPS-VGG distance per image (B,), lower is better: unit-normalise
    each stage's channels, squared difference, per-channel linear
    calibration, spatial mean, sum over stages (IQA_pytorch LPIPSvgg)."""
    x, y = _as_input(x, params), _as_input(y, params)
    fx = params["vgg16"](_nchw(x), _max_pool2)
    fy = params["vgg16"](_nchw(y), _max_pool2)
    score = 0.0
    for k in range(5):
        nx = fx[k] / (torch.linalg.vector_norm(fx[k], dim=1, keepdim=True)
                      + 1e-10)
        ny = fy[k] / (torch.linalg.vector_norm(fy[k], dim=1, keepdim=True)
                      + 1e-10)
        w = params["lins"][k].view(1, -1, 1, 1)
        score = score + (w * (nx - ny) ** 2).sum(1).mean((1, 2))
    return score


# --------------------------------------------------------------------- DISTS
@torch.inference_mode()
def dists(params: dict, x, y, c1: float = 1e-6,
          c2: float = 1e-6) -> torch.Tensor:
    """DISTS per image (B,), lower is better: a texture term from channel
    means and a structure term from channel (co)variances, weighted by the
    learned alpha / beta (normalised by their joint sum)."""
    x, y = _as_input(x, params), _as_input(y, params)
    fx = [x.permute(0, 3, 1, 2)] + params["vgg16"](_nchw(x), _l2_pool)
    fy = [y.permute(0, 3, 1, 2)] + params["vgg16"](_nchw(y), _l2_pool)
    w_sum = sum(a.sum() for a in params["alpha"]) + \
        sum(b.sum() for b in params["beta"])
    dist1 = dist2 = 0.0
    for k in range(6):
        alpha = params["alpha"][k].view(1, -1) / w_sum
        beta = params["beta"][k].view(1, -1) / w_sum
        mx = fx[k].mean((2, 3))
        my = fy[k].mean((2, 3))
        s1 = (2 * mx * my + c1) / (mx ** 2 + my ** 2 + c1)
        dist1 = dist1 + (alpha * s1).sum(-1)
        vx = (fx[k] ** 2).mean((2, 3)) - mx ** 2
        vy = (fy[k] ** 2).mean((2, 3)) - my ** 2
        cxy = (fx[k] * fy[k]).mean((2, 3)) - mx * my
        s2 = (2 * cxy + c2) / (vx + vy + c2)
        dist2 = dist2 + (beta * s2).sum(-1)
    return 1.0 - (dist1 + dist2)


# ------------------------------------------------------------------- loaders
def build_params(host: dict, device="cuda") -> dict:
    """Metric parameters on ``device`` from host tensors: ``host["vgg16"]``
    a torchvision-format VGG16 state dict (``features.{i}.weight`` OIHW),
    loaded with ``strict=True``; ``lins`` / ``alpha`` / ``beta`` lists of
    per-channel vectors, where present."""
    vgg = VGG16Features()
    vgg.load_state_dict(host["vgg16"], strict=True)
    out = {"vgg16": vgg.to(device).eval()}
    for key in ("lins", "alpha", "beta"):
        if key in host:
            out[key] = [torch.as_tensor(np.asarray(v), dtype=torch.float32)
                        .reshape(-1).to(device) for v in host[key]]
    return out


def init_lpips_params(rng=None, with_dists: bool = False,
                      device="cuda") -> dict:
    """Random-init parameters (a runnable pipeline without weight files):
    the JAX package's draws from ``np.random.default_rng(rng or 0)``, so
    the same numbers (conv weights N(0, 0.05) HWIO, zero biases, heads
    U[0, 1))."""
    rng = np.random.default_rng(0 if rng is None else rng)
    sd, cin = {}, 3
    for idx, cout in zip(conv_indices(),
                         [c for c in _VGG16_PLAN if c != "M"]):
        k = rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32)
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        sd[f"features.{idx}.bias"] = torch.zeros(cout)
        cin = cout
    host = {"vgg16": sd,
            "lins": [rng.random(c).astype(np.float32) for c in _STAGE_CHNS]}
    if with_dists:
        chns = [3] + _STAGE_CHNS
        host["alpha"] = [rng.random(c).astype(np.float32) for c in chns]
        host["beta"] = [rng.random(c).astype(np.float32) for c in chns]
    return build_params(host, device)


def _load_torch(path) -> dict:
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: torch.as_tensor(v).detach().float() for k, v in sd.items()
            if torch.is_tensor(v) or isinstance(v, np.ndarray)}


def _vgg16_state_dict(sd: dict) -> dict:
    """The 13 convs of a torchvision vgg16 state dict (``features.N``) or an
    IQA_pytorch ``stageK.N`` layout, under torchvision's names."""
    if any(k.startswith("features.") for k in sd):
        return {f"features.{i}.{p}": sd[f"features.{i}.{p}"]
                for i in conv_indices() for p in ("weight", "bias")}
    keys = sorted(
        (k for k in sd if k.endswith(".weight") and sd[k].ndim == 4),
        key=lambda k: (int(k.split("stage")[1].split(".")[0]),
                       int(k.split(".")[1])))
    if len(keys) != 13:
        raise ValueError(f"expected 13 VGG16 convs, got {len(keys)}")
    out = {}
    for i, k in zip(conv_indices(), keys):
        out[f"features.{i}.weight"] = sd[k]
        out[f"features.{i}.bias"] = sd[k[:-len("weight")] + "bias"]
    return out


def load_lpips_weights(vgg16_path: str, lpips_path: str | None = None,
                       device="cuda") -> dict:
    """LPIPS parameters from torch files: a torchvision vgg16 state dict
    (or a combined LPIPSvgg dump, then ``lpips_path`` may be None and the
    linear weights are read from the same file: official
    ``lin{k}.model.1.weight``, IQA_pytorch ``weights.{k}``, or ``w{k}``)."""
    sd = _load_torch(vgg16_path)
    if lpips_path is not None:
        sd.update(_load_torch(lpips_path))
    lins = []
    for k in range(5):
        for key in (f"lin{k}.model.1.weight", f"lins.{k}.model.1.weight",
                    f"weights.{k}", f"w{k}"):
            if key in sd:
                lins.append(sd[key].reshape(-1))
                break
        else:
            raise KeyError(f"no LPIPS linear weight found for stage {k}")
    return build_params({"vgg16": _vgg16_state_dict(sd), "lins": lins},
                        device)


def load_dists_weights(vgg16_path: str, dists_path: str | None = None,
                       device="cuda") -> dict:
    """DISTS parameters from torch files (the official release stores
    alpha / beta of shape (1, 3+64+128+256+512+512, 1, 1))."""
    sd = _load_torch(vgg16_path)
    if dists_path is not None:
        sd.update(_load_torch(dists_path))
    chns = [3] + _STAGE_CHNS
    alpha, beta = sd["alpha"].reshape(-1), sd["beta"].reshape(-1)
    if alpha.numel() != sum(chns) or beta.numel() != sum(chns):
        raise ValueError(f"alpha / beta of {alpha.numel()} / {beta.numel()} "
                         f"values, expected {sum(chns)}")
    return build_params({"vgg16": _vgg16_state_dict(sd),
                         "alpha": list(torch.split(alpha, chns)),
                         "beta": list(torch.split(beta, chns))}, device)
