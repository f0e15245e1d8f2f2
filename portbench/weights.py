"""Seeded weights for a configuration, made on the device in one draw.

Every parameter of the reference's list (:func:`portbench.reference.edvr.
param_specs`) is a slice of one uniform draw from a ``torch.Generator`` on
the device, scaled by its kind:

  * ``default``: kaiming (He) uniform, standard deviation sqrt(2 /
    fan_in), so activations keep their scale through the network's depth
    (torch's Conv2d default, a third of that variance, shrinks them ~2.5x a
    layer, and the offset chains' features would be near zero);
  * ``residual``: the residual blocks' kaiming-normal x 0.1, as a uniform of
    the same standard deviation (sqrt(2 / fan_in) x 0.1);
  * ``offset``: the DCN offset / mask convs, zero at init in the published
    model (so every offset would be 0); here a uniform of standard deviation
    ``offset_gain`` / sqrt(fan_in), so the offsets reach a few pixels and
    the masks spread, as in a trained model;
  * each kind's ``_bias``: U(+-1/sqrt(fan_in)), a tenth of it for the
    residual blocks.

The same seed gives the same weights on every device of one type.  The
state is returned in ``dtype``, the type the weights are served in.
"""
from __future__ import annotations

import math

import torch

_SQRT3 = math.sqrt(3.0)


def _bound(kind: str, fan_in: int, offset_gain: float) -> float:
    if kind == "default":
        return _SQRT3 * math.sqrt(2.0 / fan_in)
    if kind in ("default_bias", "offset_bias"):
        return 1.0 / math.sqrt(fan_in)
    if kind == "residual":
        return _SQRT3 * math.sqrt(2.0 / fan_in) * 0.1
    if kind == "residual_bias":
        return 0.1 / math.sqrt(fan_in)
    if kind == "offset":
        return _SQRT3 * offset_gain / math.sqrt(fan_in)
    raise ValueError(f"unknown init kind {kind!r}")


def make_params(specs, seed: int, device, dtype: torch.dtype,
                offset_gain: float) -> dict[str, torch.Tensor]:
    """{name: tensor} for ``specs`` ((name, shape, kind, fan_in), ...)."""
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(total, generator=gen, device=device,
                      dtype=torch.float32).mul_(2).sub_(1)
    params, at = {}, 0
    for name, shape, kind, fan_in in specs:
        n = math.prod(shape)
        params[name] = (flat[at:at + n].view(shape)
                        * _bound(kind, fan_in, offset_gain)).to(dtype)
        at += n
    return params
