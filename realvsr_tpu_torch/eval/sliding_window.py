"""Sliding-window full-sequence inference helpers.

Counterpart of ``realvsr_tpu/eval/sliding_window.py``: the reference's
``utils/util.py:222-261`` (single_forward / flipx4_forward self-ensemble)
and the per-frame windowing of its eval scripts
(``test_RealVSR_wi_GT.py:113-119``), on one model forward.
"""
from __future__ import annotations

import functools
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


@functools.cache
def _copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream the restore entry copies outputs to the host on, one a
    device."""
    return torch.cuda.Stream(device)


class Download:
    """One output on its way to the host, queued when made and waited for
    by :meth:`result`.

    The cast to float32 is queued on the current (compute) stream.  A CUDA
    output is then copied on the device's copy stream, once the cast is
    done, into a fresh pinned host tensor from torch's caching host
    allocator (a block reused once its last owner drops it, with no new
    ``cudaHostAlloc``); the device tensor is held for the copy stream
    (``record_stream``).  The host waits for nothing here, so work queued
    after it on the compute stream runs beside the copy."""

    def __init__(self, out: torch.Tensor):
        self.out = out.float()
        if not self.out.is_cuda:
            return
        compute = torch.cuda.current_stream(self.out.device)
        self.computed = compute.record_event()
        copy = _copy_stream(self.out.device)
        copy.wait_event(self.computed)
        self.host = torch.empty(self.out.shape, dtype=torch.float32,
                                pin_memory=True)
        with torch.cuda.stream(copy):
            self.host.copy_(self.out, non_blocking=True)
        self.out.record_stream(copy)
        self.copied = copy.record_event()

    def result(self, req=None) -> np.ndarray:
        """The output as the caller's own float32 numpy array: the wait for
        its compute (span ``restore.wait``; a CPU output has nothing to
        wait for), then for its copy and the array's wrap
        (``restore.download``)."""
        cuda = self.out.is_cuda
        with trace.span("restore.wait", req):
            if cuda:
                self.computed.synchronize()
        with trace.span("restore.download", req):
            if cuda:
                self.copied.synchronize()
                return self.host.numpy()
            return self.out.cpu().numpy()


def to_host(out: torch.Tensor, req=None) -> np.ndarray:
    """``out`` as a float32 numpy array that is the caller's own: a
    :class:`Download` queued and waited for at once.  A CUDA output lands
    in pinned host memory (the array keeps its pinned tensor alive); a CPU
    output is ``out.float().cpu().numpy()``."""
    return Download(out).result(req)


def sliding_window_infer(forward: Callable, frames: np.ndarray, n_frames: int,
                         padding: str = "replicate", flip_test: bool = False,
                         device="cuda"):
    """Yield (frame_idx, float32 numpy output) over a (T, H, W, C) sequence;
    the sequence and every window's frame indices are moved to ``device``
    once, so a frame's gather and forward wait for nothing on the host.

    Each frame is the caller's own float32 array (no frame aliases another
    or changes later; on CUDA it lies in pinned host memory, see
    :class:`Download`).  The first ask runs its own window alone.  From the
    second on, the entry runs one window ahead: it queues frame k's
    download, gathers and launches frame k+1's forward, and only then waits
    for frame k, so the device computes k+1 while k is copied and handed
    back.  ``close()`` drops a queued window without waiting for it.

    Traced (:mod:`~realvsr_tpu_torch.utils.trace`): ``restore.upload`` once
    a clip, then a frame's ``restore.gather`` (its window's gather),
    ``restore.forward`` (the model, its flips included) and
    :meth:`Download.result`'s spans, all with ``req`` (clip sequence
    number, frame index); a frame's gather and forward run inside the
    previous frame's ask once the entry runs ahead.  Counter
    ``restore.ahead``: 1 for a frame whose window was launched before the
    caller asked for it, else 0."""
    clip = next(CLIP_IDS)
    max_idx = frames.shape[0]
    with trace.span("restore.upload", (clip, 0)):
        frames_t = torch.from_numpy(
            np.ascontiguousarray(frames, dtype=np.float32)).to(device)
        select = torch.as_tensor(
            [index_generation(i, max_idx, n_frames, padding=padding)
             for i in range(max_idx)], device=device)

    def launch(idx):
        req = (clip, idx)
        with trace.span("restore.gather", req):
            window = frames_t.index_select(0, select[idx])
        with trace.span("restore.forward", req):
            if flip_test:
                return flipx4_forward(forward, window)
            return forward(window)

    ahead = None                  # the next frame's output, launched early
    for idx in range(max_idx):
        trace.count("restore.ahead", int(ahead is not None))
        pending = Download(launch(idx) if ahead is None else ahead)
        ahead = launch(idx + 1) if 0 < idx < max_idx - 1 else None
        yield idx, pending.result((clip, idx))
