"""Flow warping: bilinear sampling at absolute pixel positions.

Counterpart of ``realvsr_tpu/ops/warp.py``, the reference's ``flow_warp``
(``codes/models/archs/arch_util.py:47-80``): sample at ``grid + flow``,
flow in (dx, dy) order, align_corners=True pixel centres (coordinate 0 is
pixel 0's centre, W - 1 the last one's), 'zeros' or 'border' padding.

``F.grid_sample`` does the sampling (the JAX package gathers with XLA).
It takes normalised coordinates; these are formed for ``align_corners=
False``, (2p + 1) / size - 1, whose unnormalisation gives back the pixel
position p exactly in the sampler's convention at any size: the
align_corners=True form, 2p / (size - 1) - 1, divides by zero on a side of
1 pixel.  Both paddings act on the pixel position as the JAX gathers do.
The sampling runs in f32 (the JAX weights are f32) and returns the
input's dtype.  The pixel grid and the size vector are made once a (size,
device) and kept (:func:`_grid`): made from a Python list at each call,
the size's upload would wait for the device's queue (a blocking copy),
once a warp.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=64)
def _grid(h: int, w: int, device: torch.device):
    """(the pixel grid (1, H, W, 2) in (x, y) order, the size [W, H]) in
    f32 on ``device``; ordinary tensors even when first asked for under
    ``torch.inference_mode``, so a later autograd pass can save them."""
    with torch.inference_mode(False):
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij")
        size = torch.tensor([w, h], dtype=torch.float32, device=device)
        return torch.stack([gx, gy], dim=-1)[None], size


def grid_sample_bilinear(x: torch.Tensor, coords: torch.Tensor,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """Sample NHWC ``x`` (B, H, W, C) at absolute pixel positions ``coords``
    (B, Ho, Wo, 2), (x, y) order; returns (B, Ho, Wo, C)."""
    if padding_mode not in ("zeros", "border"):
        raise ValueError(f"padding_mode {padding_mode!r}")
    h, w = x.shape[1:3]
    size = _grid(h, w, x.device)[1]
    grid = (2 * coords.float() + 1) / size - 1
    out = F.grid_sample(x.permute(0, 3, 1, 2).float(), grid,
                        mode="bilinear", padding_mode=padding_mode,
                        align_corners=False)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              padding_mode: str = "zeros") -> torch.Tensor:
    """Warp NHWC ``x`` by the per-pixel flow (B, H, W, 2), (dx, dy)."""
    base = _grid(*x.shape[1:3], x.device)[0]
    return grid_sample_bilinear(x, base + flow.float(), padding_mode)
