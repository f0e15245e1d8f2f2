"""Sliding-window full-sequence inference helpers.

Counterpart of ``realvsr_tpu/eval/sliding_window.py``: the reference's
``utils/util.py:222-261`` (single_forward / flipx4_forward self-ensemble)
and the per-frame windowing of its eval scripts
(``test_RealVSR_wi_GT.py:113-119``), on one model forward.
"""
from __future__ import annotations

from typing import Callable, Mapping

import numpy as np
import torch

from realvsr_tpu_torch.utils.indexing import index_generation


def make_forward(model: torch.nn.Module,
                 params: Mapping[str, torch.Tensor] | None = None) -> Callable:
    """(T, H, W, C)-window → (H, W, C) forward with batch dim 1.

    ``params``: a state dict loaded into ``model`` with ``strict=True``, or
    None to keep the model's weights.  The window is cast to the model's
    compute dtype ``model.dtype``; the output keeps it.  The parameters are
    cast to that dtype here, once (inference keeps no f32 copy), so the
    modules' casts at use do nothing per window.
    """
    if params is not None:
        model.load_state_dict(params, strict=True)
    model.eval()
    dtype = model.dtype
    model.to(dtype)

    @torch.inference_mode()
    def fwd(window: torch.Tensor) -> torch.Tensor:
        return model(window[None].to(dtype))[0]

    return fwd


def flipx4_forward(forward: Callable, window: torch.Tensor) -> torch.Tensor:
    """Self-ensemble: average over H/W/HW flips (utils/util.py:240-261)."""
    acc = forward(window).float()
    acc = acc + torch.flip(forward(torch.flip(window, (-2,))), (-2,))
    acc = acc + torch.flip(forward(torch.flip(window, (-3,))), (-3,))
    acc = acc + torch.flip(forward(torch.flip(window, (-3, -2))), (-3, -2))
    return acc / 4.0


def sliding_window_infer(forward: Callable, frames: np.ndarray, n_frames: int,
                         padding: str = "replicate", flip_test: bool = False,
                         device="cuda"):
    """Yield (frame_idx, float32 numpy output) over a (T, H, W, C) sequence;
    the sequence is moved to ``device`` once."""
    max_idx = frames.shape[0]
    frames_t = torch.from_numpy(
        np.ascontiguousarray(frames, dtype=np.float32)).to(device)
    for idx in range(max_idx):
        select = index_generation(idx, max_idx, n_frames, padding=padding)
        window = frames_t[torch.as_tensor(select, device=device)]
        if flip_test:
            out = flipx4_forward(forward, window)
        else:
            out = forward(window)
        yield idx, out.float().cpu().numpy()
