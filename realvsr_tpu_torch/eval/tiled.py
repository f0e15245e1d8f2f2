"""Spatially tiled full-frame inference.

Counterpart of ``realvsr_tpu/eval/tiled.py``: bounds device memory for
large frames (1080p and up) by running the model over overlapping spatial
tiles and keeping each tile's centre.  Same tile grid, same clamped edge
tiles (an edge tile moves inward and keeps the full tile shape) and the
same valid-centre stitching as the JAX functions.  :func:`tiled_forward`
runs the tiles one by one; :func:`make_batched_tiled_forward` slices every
tile on the device, runs them as one model batch and stitches on the
device, so the frame leaves the device in one transfer.

Beside it, a copy of ``realvsr_tpu/eval/spatial.py::receptive_field_rows``:
the tiled output equals the full-frame one on the pixels farther than that
from every inner tile edge.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch


def receptive_field_rows(front_RBs: int = 5, back_RBs: int = 10,
                         max_offset: int = 4) -> int:
    """Conservative half-receptive-field (rows) of EDVR / EDVR_NoUp at input
    resolution, rounded up to a multiple of 4 (the stride-4 pyramid's
    phase): conv_first and the front ResBlocks (1 + 2 front), the L2 / L3
    pyramid (9), PCD's offset convs and DCNs (taps ±1 and the clamp ±R,
    x4 at L1 scale) and the reconstruction trunk (2 back + 4)."""
    front = 1 + 2 * front_RBs
    pyramid = 9
    pcd = 4 * (8 + (max_offset + 1)) + 2 * (4 + (max_offset + 1)) \
        + (2 + (max_offset + 1)) + (2 + (max_offset + 1))
    recon = 2 * back_RBs + 4
    rf = front + pyramid + pcd + recon
    return -(-rf // 4) * 4


def tile_grid(h: int, w: int, tile_hw, overlap: int):
    """The tiles of an h x w frame: ((th, tw), [(ty, tx, (vy0, vy1, vx0,
    vx1)), ...]), each tile's origin and the frame rows and columns of its
    valid centre (the overlap dropped on every side that is not a frame
    edge)."""
    th, tw = min(tile_hw[0], h), min(tile_hw[1], w)
    step_h, step_w = th - 2 * overlap, tw - 2 * overlap
    if step_h <= 0 or step_w <= 0:
        raise ValueError(f"tile {th}x{tw} too small for overlap {overlap}")
    tiles = []
    for y0 in range(0, max(h - 2 * overlap, 1), step_h):
        for x0 in range(0, max(w - 2 * overlap, 1), step_w):
            ty, tx = min(y0, h - th), min(x0, w - tw)
            valid = (ty + (overlap if ty > 0 else 0),
                     ty + th - (overlap if ty + th < h else 0),
                     tx + (overlap if tx > 0 else 0),
                     tx + tw - (overlap if tx + tw < w else 0))
            tiles.append((ty, tx, valid))
    return (th, tw), tiles


def _crop(pred, ty, tx, valid, scale):
    vy0, vy1, vx0, vx1 = valid
    return pred[(vy0 - ty) * scale:(vy1 - ty) * scale,
                (vx0 - tx) * scale:(vx1 - tx) * scale]


def tiled_forward(forward: Callable, window: torch.Tensor,
                  tile_hw: tuple[int, int] = (256, 512), overlap: int = 32,
                  scale: int = 1) -> torch.Tensor:
    """Apply ``forward`` ((T, th, tw, C) -> (th * scale, tw * scale, C))
    over overlapping tiles of a (T, H, W, C) window, one tile at a time.
    Returns the (H * scale, W * scale, C) frame as a float32 tensor on the
    host, as the JAX function returns a host array."""
    window = _tensor(window)
    t, h, w, c = window.shape
    (th, tw), tiles = tile_grid(h, w, tile_hw, overlap)
    out = torch.zeros(h * scale, w * scale, c, dtype=torch.float32)
    for ty, tx, valid in tiles:
        pred = forward(window[:, ty:ty + th, tx:tx + tw].contiguous())
        vy0, vy1, vx0, vx1 = valid
        out[vy0 * scale:vy1 * scale, vx0 * scale:vx1 * scale] = _crop(
            pred, ty, tx, valid, scale).float().cpu()
    return out


def _tensor(window):
    if isinstance(window, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(window))
    return window


def _prepare(model, state_dict, device):
    """Load ``state_dict`` (strict) if given, move the model to ``device``
    and cast its weights to its compute dtype once."""
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(device=device, dtype=model.dtype).eval()


def make_tiled_forward(model: torch.nn.Module,
                       state_dict: Mapping[str, torch.Tensor] | None = None,
                       tile_hw=(256, 512), overlap: int = 32, scale: int = 1,
                       device="cuda") -> Callable:
    """A window (T, H, W, C) -> frame forward that runs :func:`tiled_forward`
    with the model on ``device``; the window is cast to ``model.dtype``."""
    model = _prepare(model, state_dict, device)

    @torch.inference_mode()
    def tile_fwd(tile):
        return model(tile[None].to(device, model.dtype))[0]

    def forward(window):
        return tiled_forward(tile_fwd, window, tile_hw=tile_hw,
                             overlap=overlap, scale=scale)

    return forward


def batched_tiled_apply(model: torch.nn.Module, tile_hw=(576, 1024),
                        overlap: int = 32, scale: int = 1) -> Callable:
    """``window (T, H, W, C) -> (H * scale, W * scale, C)`` on the window's
    device: every tile sliced there, the tiles run as one model batch, and
    the valid centres stitched into one frame there.  The model holds the
    weights (the JAX function takes them as an argument)."""

    def forward(window: torch.Tensor) -> torch.Tensor:
        t, h, w, c = window.shape
        (th, tw), tiles = tile_grid(h, w, tile_hw, overlap)
        batch = torch.stack([window[:, ty:ty + th, tx:tx + tw]
                             for ty, tx, _ in tiles])
        preds = model(batch)  # (n, th * s, tw * s, c)
        out = preds.new_zeros(h * scale, w * scale, c)
        for pred, (ty, tx, valid) in zip(preds, tiles):
            vy0, vy1, vx0, vx1 = valid
            out[vy0 * scale:vy1 * scale, vx0 * scale:vx1 * scale] = _crop(
                pred, ty, tx, valid, scale)
        return out

    return forward


def make_batched_tiled_forward(model: torch.nn.Module,
                               state_dict: Mapping[str, torch.Tensor]
                               | None = None,
                               tile_hw=(576, 1024), overlap: int = 32,
                               scale: int = 1, device="cuda") -> Callable:
    """:func:`batched_tiled_apply` with the model on ``device`` and its
    weights cast to ``model.dtype`` once: ``window (T, H, W, C) -> (H *
    scale, W * scale, C)`` in that dtype on the device (the caller's one
    transfer out).  Output equals :func:`tiled_forward` (same grid, same
    valid regions, same clamped edge tiles)."""
    model = _prepare(model, state_dict, device)
    apply = batched_tiled_apply(model, tile_hw, overlap, scale)

    @torch.inference_mode()
    def forward(window: torch.Tensor) -> torch.Tensor:
        return apply(_tensor(window).to(device, model.dtype))

    return forward
