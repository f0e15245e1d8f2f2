"""Sliding-window full-sequence inference helpers.

Counterpart of ``realvsr_tpu/eval/sliding_window.py``: the reference's
``utils/util.py:222-261`` (single_forward / flipx4_forward self-ensemble)
and the per-frame windowing of its eval scripts
(``test_RealVSR_wi_GT.py:113-119``), on one model forward.
"""
from __future__ import annotations

import itertools
from typing import Callable, Mapping

import numpy as np
import torch

from realvsr_tpu_torch.utils import trace
from realvsr_tpu_torch.utils.indexing import index_generation

# clip sequence numbers, the first half of the restore spans' req
CLIP_IDS = itertools.count()


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


def to_host(out: torch.Tensor, req=None) -> np.ndarray:
    """``out`` as a float32 numpy array: the cast queued and the current
    stream waited for (span ``restore.wait``; a CPU tensor has nothing to
    wait for), then the copy alone (``restore.download``)."""
    with trace.span("restore.wait", req):
        out = out.float()
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
    with trace.span("restore.download", req):
        return out.cpu().numpy()


def sliding_window_infer(forward: Callable, frames: np.ndarray, n_frames: int,
                         padding: str = "replicate", flip_test: bool = False,
                         device="cuda"):
    """Yield (frame_idx, float32 numpy output) over a (T, H, W, C) sequence;
    the sequence is moved to ``device`` once.

    Traced (:mod:`~realvsr_tpu_torch.utils.trace`): ``restore.upload`` once
    a clip, then a frame's ``restore.gather`` (its window's indices and
    gather), ``restore.forward`` (the model, its flips included) and
    :func:`to_host`'s spans, all with ``req`` (clip sequence number, frame
    index)."""
    clip = next(CLIP_IDS)
    max_idx = frames.shape[0]
    with trace.span("restore.upload", (clip, 0)):
        frames_t = torch.from_numpy(
            np.ascontiguousarray(frames, dtype=np.float32)).to(device)
    for idx in range(max_idx):
        req = (clip, idx)
        with trace.span("restore.gather", req):
            select = index_generation(idx, max_idx, n_frames,
                                      padding=padding)
            window = frames_t[torch.as_tensor(select, device=device)]
        with trace.span("restore.forward", req):
            if flip_test:
                out = flipx4_forward(forward, window)
            else:
                out = forward(window)
        yield idx, to_host(out, req)
