"""Carry weights from the JAX package to the port.

:func:`state_dict_from_jax` takes a flax param tree as nested dicts of numpy
arrays (``jax.device_get(params)`` or ``np.asarray`` leaves; no JAX import
is needed here) and returns a state dict under the reference torch key names
with OIHW weights — the keys the port's modules carry, so
``model.load_state_dict(state_dict_from_jax(params), strict=True)`` loads.
The naming rules are those of ``realvsr_tpu/train/torch_import.py``
(``flax_path_to_torch_key``):

  * drop ``Conv_N`` wrapper segments of the JAX ``Conv2d`` module,
  * ``blockN`` (Blocks container) → ``N`` (``nn.Sequential`` index),
  * leaf ``kernel`` → ``weight``; a conv's kernel (under ``Conv_N``, and
    the DCN's 4-D ``weight``) HWIO → OIHW, DHWIO → OIDHW,
  * a ``kernel`` that is not under ``Conv_N`` is a flax ``nn.Dense``
    (2-D, (in, out) → torch's (out, in)) or ``nn.ConvTranspose`` (4-D or
    5-D): flax does not flip its kernel (``transpose_kernel=False``) where
    ``conv_transpose2d`` / ``3d`` do, so the spatial axes are flipped and
    (..., in, out) becomes (in, out, ...),
  * BatchNorm ``scale`` / ``mean`` / ``var`` → ``weight`` /
    ``running_mean`` / ``running_var``; the running statistics come from
    the ``batch_stats`` collection when a variables dict ``{"params",
    "batch_stats"}`` is given,
  * everything else keeps its name (PReLU's ``alpha``; the DCN modules'
    ``weight`` / ``bias`` and ``conv_offset_mask``; ``ResBlock``'s unnamed
    flax convs ``Conv2d_0`` / ``Conv2d_1``, the port's attribute names).

:func:`vgg16_state_dict_from_jax` and :func:`perceptual_params_from_jax`
carry the JAX package's LPIPS / DISTS parameters (``realvsr_tpu/eval/
perceptual.py``: 13 HWIO convs and the metric heads) to the port's
``eval/perceptual.py``, the backbone under torchvision's ``vgg16`` names.
"""
from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LEAF_MAP = {"kernel": "weight", "scale": "weight",
             "mean": "running_mean", "var": "running_var"}


def flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    parts = []
    for p in path[:-1]:
        if re.fullmatch(r"Conv_\d+", p):
            continue
        m = re.fullmatch(r"block(\d+)", p)
        parts.append(m.group(1) if m else p)
    leaf = path[-1]
    parts.append(_LEAF_MAP.get(leaf, leaf))
    return ".".join(parts)


def _leaves(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            yield from _leaves(val, path)
        else:
            yield path, val


def _to_torch_layout(path: tuple[str, ...], t: np.ndarray) -> np.ndarray:
    under_conv = len(path) > 1 and re.fullmatch(r"Conv_\d+", path[-2])
    if path[-1] == "kernel" and not under_conv:
        if t.ndim == 2:                       # nn.Dense
            return t.T
        if t.ndim >= 4:                       # nn.ConvTranspose
            sp = tuple(range(t.ndim - 2))
            return np.flip(t, sp).transpose(t.ndim - 2, t.ndim - 1, *sp)
    if t.ndim >= 4:                           # conv: (k..., I, O) → (O, I, k...)
        return t.transpose(t.ndim - 1, t.ndim - 2, *range(t.ndim - 2))
    return t


def state_dict_from_jax(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax params, or a variables dict ``{"params", "batch_stats"}``
    (nested dicts of arrays) → float32 torch state dict."""
    if "params" in params:
        trees = [params["params"], params.get("batch_stats") or {}]
    else:
        trees = [params]
    out = {}
    for tree in trees:
        for path, leaf in _leaves(tree):
            t = _to_torch_layout(path, np.asarray(leaf, dtype=np.float32))
            # a fresh C-order copy: a flip keeps negative strides
            out[flax_path_to_torch_key(path)] = torch.from_numpy(t.copy())
    return out


def vgg16_state_dict_from_jax(convs) -> dict[str, torch.Tensor]:
    """The JAX package's VGG16 convs (a list of 13 ``{"kernel": HWIO,
    "bias"}``) -> a torchvision-format state dict (``features.{i}.weight``
    OIHW, ``features.{i}.bias``), float32."""
    from realvsr_tpu_torch.eval.perceptual import conv_indices

    indices = conv_indices()
    if len(convs) != len(indices):
        raise ValueError(f"expected 13 VGG16 convs, got {len(convs)}")
    out = {}
    for idx, conv in zip(indices, convs):
        k = np.asarray(conv["kernel"], dtype=np.float32)
        out[f"features.{idx}.weight"] = torch.tensor(k.transpose(3, 2, 0, 1))
        out[f"features.{idx}.bias"] = torch.tensor(
            np.asarray(conv["bias"], dtype=np.float32))
    return out


def perceptual_params_from_jax(params: Mapping[str, Any]) -> dict:
    """JAX LPIPS / DISTS parameters (``{"convs", "lins"}`` and / or
    ``{"alpha", "beta"}``, arrays) -> the host form the port's
    ``eval/perceptual.py::build_params`` takes: ``{"vgg16": state dict,
    "lins" / "alpha" / "beta": [float32 tensors]}``."""
    out = {"vgg16": vgg16_state_dict_from_jax(params["convs"])}
    for key in ("lins", "alpha", "beta"):
        if key in params:
            out[key] = [torch.tensor(np.asarray(v, dtype=np.float32))
                        for v in params[key]]
    return out
