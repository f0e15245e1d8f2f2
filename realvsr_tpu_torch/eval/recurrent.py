"""Whole-clip restore of a recurrent model (BasicVSR++), frame by frame.

A recurrent model cannot be driven window by window: frame t's output
needs the backward branches over every later frame.  So the clip is
uploaded once, its features and both directions' flows are computed over
all frames, the propagation branches run over the whole clip with every
frame's feature maps kept on the device, and then the frames are handed
back in order, each one's reconstruction launched one frame ahead and
downloaded through :class:`~realvsr_tpu_torch.eval.sliding_window.
Download` (pinned host memory, the copy stream), as the sliding window
hands its frames back.
"""
from __future__ import annotations

import numpy as np
import torch

from realvsr_tpu_torch.eval.sliding_window import CLIP_IDS, Download
from realvsr_tpu_torch.models.basicvsr_pp import BRANCHES
from realvsr_tpu_torch.utils import trace


def recurrent_infer(model: torch.nn.Module, frames: np.ndarray,
                    device="cuda"):
    """Yield (frame_idx, float32 numpy output) over a (T, H, W, C) clip
    through ``model`` (a ``recurrent`` model: :class:`~realvsr_tpu_torch.
    models.basicvsr_pp.BasicVSRPlusPlus`), in the model's compute dtype and
    with its weights as they are (``tools/_cli.py::restorer`` casts them
    once).

    The first ask uploads the clip and launches feature extraction, the
    flows and the four branches, then frame 0's reconstruction.  Every ask
    queues its frame's download and launches the next frame's
    reconstruction before it waits for its own frame, so the device
    reconstructs frame t + 1 while frame t is copied and handed back.  Each
    frame is the caller's own float32 array, as the sliding window's.
    ``close()`` drops what is queued without waiting for it.

    Traced (:mod:`~realvsr_tpu_torch.utils.trace`): ``restore.upload``,
    ``restore.extract`` and ``restore.flow`` once a clip (req (clip, 0);
    the last two with ``frames``, the clip's length), ``restore.propagate``
    once a branch (req (clip, branch), attribute ``branch``), and a
    frame's ``restore.upsample`` and :meth:`Download.result`'s
    ``restore.wait`` / ``restore.download`` with req (clip, frame).
    Counter ``restore.ahead``: 1 for a frame whose reconstruction was
    launched before the caller asked for it, else 0 (the first)."""
    clip = next(CLIP_IDS)
    n = frames.shape[0]
    lqs, feats = _propagate(model, frames, device, clip)

    @torch.inference_mode()
    def launch(t):
        with trace.span("restore.upsample", (clip, t)):
            return model.reconstruct(lqs[:, t], feats, t)[0]

    ahead = None                  # the next frame's output, launched early
    for t in range(n):
        trace.count("restore.ahead", int(ahead is not None))
        pending = Download(launch(t) if ahead is None else ahead)
        ahead = launch(t + 1) if t + 1 < n else None
        yield t, pending.result((clip, t))


@torch.inference_mode()
def _propagate(model, frames: np.ndarray, device, clip: int):
    """(the clip on the device (1, T, H, W, C) in the model's dtype, its
    feature maps: ``spatial`` and each branch's, a list a frame)."""
    n = frames.shape[0]
    with trace.span("restore.upload", (clip, 0)):
        lqs = torch.from_numpy(np.ascontiguousarray(
            frames, dtype=np.float32)).to(device)[None].to(model.dtype)
    with trace.span("restore.extract", (clip, 0), frames=n):
        feats = {"spatial": model.extract(lqs)}
    with trace.span("restore.flow", (clip, 0), frames=n):
        flows_forward, flows_backward = model.compute_flow(lqs)
    for branch in BRANCHES:
        with trace.span("restore.propagate", (clip, branch), branch=branch):
            model.propagate(feats, flows_backward if branch.startswith(
                "backward") else flows_forward, branch)
    return lqs, feats
