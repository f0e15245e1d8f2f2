"""Streaming video inference: each frame's feature pyramid computed once.

Counterpart of ``realvsr_tpu/eval/streaming.py`` (``StreamingRunner``).
The sliding window computes every frame's pyramid N times, once in each
of the N windows that hold it; the EDVR front end (``conv_first``, the
front ResBlocks, the L2 / L3 pyramid convs) depends on the one frame only,
so the runner computes it once per new frame (the model's ``mode=
"pyramid"``) and runs PCD alignment, fusion and the reconstruction trunk
per window on the cached pyramids (``mode="fuse"``).  Outputs equal the
per-window model's: this is memoisation, not an approximation.

On the card the kernels compute each pixel the same way at any batch, but
the front end's ``F.conv2d`` convs (``conv_first``, the stride-2 convs) run
cuDNN, which may pick another algorithm for one frame than for a window
of N; there the streamed output can differ from the sliding window's by
that rounding.

Supported models: :class:`~realvsr_tpu_torch.models.edvr.EDVRNoUp` and
:class:`~realvsr_tpu_torch.models.edvr.EDVR` (x4, TSA), the models with the
pyramid / fuse modes.  TDAN has none and is refused.
"""
from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch

from realvsr_tpu_torch.models.edvr import _EDVRBase
from realvsr_tpu_torch.utils.indexing import index_generation


class StreamingRunner:
    """Sequential video inference with per-frame pyramid caching.

    ``model``: an EDVR_NoUp or EDVR module; ``state_dict``: loaded into it
    with ``strict=True``, or None to keep its weights.  The model moves to
    ``device`` and its weights are cast to its compute dtype ``model.dtype``
    once, as :func:`~realvsr_tpu_torch.eval.sliding_window.make_forward`
    does; every method casts the frames to that dtype once and returns the
    restored frames on ``device`` in it.
    """

    def __init__(self, model: torch.nn.Module,
                 state_dict: Mapping[str, torch.Tensor] | None = None,
                 padding: str = "replicate", device="cuda"):
        if not isinstance(model, _EDVRBase):
            raise ValueError(
                f"StreamingRunner: {type(model).__name__} has no pyramid / "
                "fuse modes (EDVR_NoUp and EDVR have)")
        if state_dict is not None:
            model.load_state_dict(state_dict, strict=True)
        self.dtype = model.dtype
        self.device = torch.device(device)
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self.padding = padding
        self.n = model.nframes

    def _frames(self, frames) -> torch.Tensor:
        if isinstance(frames, np.ndarray):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        return frames.to(self.device, self.dtype).contiguous()

    def _pyramid(self, frames: torch.Tensor):
        """(B, H, W, C) frames -> their (L1, L2, L3) pyramids."""
        return self.model(frames, mode="pyramid")

    def _fuse(self, pyrs, center: torch.Tensor) -> torch.Tensor:
        """The window of the N pyramids ``pyrs`` (each of batch B) with its
        centre frames (B, H, W, C) -> (B, H', W', C)."""
        stacked = tuple(torch.stack([p[lvl] for p in pyrs], dim=1)
                        for lvl in range(3))
        return self.model((*stacked, center), mode="fuse")

    def _check_scan(self) -> None:
        if self.n != 3 or self.padding != "replicate":
            raise ValueError("run_scan takes 3-frame windows with replicate "
                             f"padding, got N = {self.n}, {self.padding!r}")

    @torch.inference_mode()
    def run(self, frames) -> torch.Tensor:
        """frames: (T, H, W, C) tensor or array.  Returns the (T, H', W', C)
        restored frames, equal to the full model on each sliding window."""
        fr = self._frames(frames)
        t_total = fr.shape[0]
        pyrs = [self._pyramid(fr[t:t + 1]) for t in range(t_total)]
        outs = []
        for t in range(t_total):
            sel = index_generation(t, t_total, self.n, padding=self.padding)
            outs.append(self._fuse([pyrs[s] for s in sel], fr[t:t + 1])[0])
        return torch.stack(outs)

    @torch.inference_mode()
    def run_scan(self, frames) -> torch.Tensor:
        """:meth:`run` as one carried loop, N = 3 and replicate padding
        only: the last two pyramids stay on the device, each step computes
        the pyramid of one new frame and restores the window centred on the
        frame before it; nothing returns to the host until the end."""
        self._check_scan()
        return self._scan(self._frames(frames)[:, None])[:, 0]

    @torch.inference_mode()
    def run_scan_clips(self, clips) -> torch.Tensor:
        """:meth:`run_scan` of B clips (B, T, H, W, C) at once, the clips
        stacked in the model's batch.  Equals per-clip :meth:`run_scan`."""
        self._check_scan()
        fr = self._frames(clips).movedim(1, 0).contiguous()
        return self._scan(fr).movedim(0, 1)

    def _scan(self, fr: torch.Tensor) -> torch.Tensor:
        """(T, B, H, W, C) -> (T, B, H', W', C): windows (t - 1, t, t + 1)
        with the borders replicated, one new pyramid a step."""
        t_total = fr.shape[0]
        prev = cur = self._pyramid(fr[0])
        outs = []
        for t in range(t_total):
            nxt = self._pyramid(fr[t + 1]) if t + 1 < t_total else cur
            outs.append(self._fuse((prev, cur, nxt), fr[t]))
            prev, cur = cur, nxt
        return torch.stack(outs)

    @torch.inference_mode()
    def run_lazy(self, frames) -> Iterator[torch.Tensor]:
        """Yields restored frame t once frame t + N // 2 is in (the
        streaming latency of N // 2 frames), computing each pyramid when a
        window first needs it and dropping those no later window reads."""
        fr = self._frames(frames)
        t_total = fr.shape[0]
        cache: dict[int, tuple] = {}

        def get(t):
            if t not in cache:
                cache[t] = self._pyramid(fr[t:t + 1])
            return cache[t]

        half = self.n // 2
        for t in range(t_total):
            sel = index_generation(t, t_total, self.n, padding=self.padding)
            yield self._fuse([get(s) for s in sel], fr[t:t + 1])[0]
            for k in [k for k in cache if k < t - half]:
                del cache[k]
