"""Spatially sharded full-frame inference: the frame's rows split over the
ranks of a process group.

Counterpart of ``realvsr_tpu/eval/spatial.py``, which shards H over a
``model`` mesh axis with ``shard_map``.  Each rank holds the whole window
(a 1080p bf16 window is ~36 MB, cheaper to copy than to exchange halos
through every conv), takes a uniform ``Hs + 2*halo``-row window CLAMPED
inside the frame (edge shards shift inward, as ``eval/tiled.py`` does),
runs the whole model on it and keeps its ``Hs`` rows wherever they landed;
the rows are then all-gathered in rank order.

Exactness: the windows never extend past the frame, so its true edges see
the model's own zero padding, and an inner window edge corrupts at most
the receptive field's width of rows, all cropped while ``halo`` reaches
that far.  The default halo is
:func:`~realvsr_tpu_torch.eval.tiled.receptive_field_rows` of the model's
depth and its DCN clamp ±R, so the default needs a clamped model
(``dcn_max_offset``); with an explicit halo an unclamped model runs too,
and then the rows within the DCN's reach of a shard edge are approximate
(its offsets are unbounded).  The kept rows equal the unsharded forward's
up to the rounding of convolutions on another shape.
"""
from __future__ import annotations

import torch

from realvsr_tpu_torch.eval.tiled import receptive_field_rows
from realvsr_tpu_torch.models.common import DCNPack
from realvsr_tpu_torch.parallel import mesh


def default_halo(model) -> int:
    """``receptive_field_rows`` of an EDVR / EDVR_NoUp ``model``'s front
    and back ResBlocks and its DCN clamp; raises for an unclamped model."""
    clamps = {m.max_offset for m in model.modules()
              if isinstance(m, DCNPack)}
    if None in clamps or len(clamps) != 1:
        raise ValueError(
            "the default halo needs a DCN clamped to ±R (dcn_max_offset): "
            "an unclamped DCN's reach is unbounded; pass halo")
    return receptive_field_rows(len(model.feature_extraction),
                                len(model.recon_trunk), int(clamps.pop()))


def shard_forward(model, window: torch.Tensor, idx: int, n_shard: int,
                  halo: int) -> torch.Tensor:
    """Shard ``idx`` of ``n_shard`` of ``model(window)``: the output rows of
    input rows [idx Hs, (idx+1) Hs) (times the model's scale), Hs = H /
    n_shard, computed on the clamped ``Hs + 2*halo``-row window.

    window: (B, N, H, W, C); H must split evenly into shards whose height
    and the halo are multiples of 4 (the stride-4 pyramid's phase)."""
    h = window.shape[2]
    hs = h // n_shard
    hw = hs + 2 * halo
    assert halo % 4 == 0, "halo must keep the stride-4 pyramid phase"
    assert hs * n_shard == h and hs % 4 == 0, (h, n_shard)
    assert hw <= h, (
        f"frame of {h} rows too short for {n_shard}-way sharding with "
        f"halo {halo} (needs >= {hw}); use the unsharded forward")
    y0 = min(max(idx * hs - halo, 0), h - hw)
    out = model(window[:, :, y0:y0 + hw])
    scale = out.shape[1] // hw
    keep0 = (idx * hs - y0) * scale
    return out[:, keep0:keep0 + hs * scale]


def spatial_sharded_forward(model, window: torch.Tensor,
                            halo: int | None = None) -> torch.Tensor:
    """The whole frame ``model(window)`` with H split over the ranks of the
    process group: each rank runs :func:`shard_forward` of its index and
    the rows are all-gathered, so every rank returns (B, H', W', C).  In a
    world of one process it is the forward of the whole frame.  ``halo``
    defaults to :func:`default_halo`."""
    world = mesh.world_size()
    if world == 1:
        return model(window)
    halo = default_halo(model) if halo is None else halo
    part = shard_forward(model, window, mesh.rank(), world, halo)
    rows = mesh.all_gather_rows(part.transpose(0, 1).contiguous())
    return rows.transpose(0, 1)
