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

A branch step is a chain of ~45 small launches at batch 1, the same shapes
at every step of a branch: launched one by one, the host takes longer
than the device runs them.  So on a CUDA tensor under inference mode the
branches' steps run through :class:`StepGraphs`, which replays the two
segments of a step (``BasicVSRPlusPlus.align_input`` and
``backbone_step``) from CUDA graphs, captured once a key
(:func:`step_key`: the branch, the features' (B, H, W, C), dtype and
device), and calls the alignment's DCN eagerly between them.  A branch's
first two steps (no alignment; no second order) run eagerly, and so does
the first second-order step of a new key: the warm-up before its capture.
"""
from __future__ import annotations

import weakref
from collections import OrderedDict

import numpy as np
import torch

from realvsr_tpu_torch.eval.sliding_window import CLIP_IDS, Download
from realvsr_tpu_torch.models.basicvsr_pp import BRANCHES
from realvsr_tpu_torch.utils import trace

MAX_SIZES = 3     # clip sizes whose captures are kept, the last used
_RUNNERS = weakref.WeakKeyDictionary()   # model -> its StepGraphs


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

    On a CUDA device the branches' steps go through the model's
    :class:`StepGraphs` (:func:`graphs`): from the third step of a branch
    on, each is replayed from the CUDA graphs of its :func:`step_key`, the
    first such step of a new key run eagerly and then captured; the first
    two steps of every branch run eagerly, so a clip of two frames or fewer
    replays nothing.  The captures of the last :data:`MAX_SIZES` clip sizes
    are kept.

    Traced (:mod:`~realvsr_tpu_torch.utils.trace`): ``restore.upload``,
    ``restore.extract`` and ``restore.flow`` once a clip (req (clip, 0);
    the last two with ``frames``, the clip's length), ``restore.propagate``
    once a branch (req (clip, branch), attribute ``branch``), and a
    frame's ``restore.upsample`` and :meth:`Download.result`'s
    ``restore.wait`` / ``restore.download`` with req (clip, frame).
    Counter ``restore.ahead``: 1 for a frame whose reconstruction was
    launched before the caller asked for it, else 0 (the first).  Counter
    ``restore.graph``: 1 for a branch step replayed from captured graphs,
    0 for one run eagerly (every step on the CPU)."""
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
    runner = graphs(model)
    for branch in BRANCHES:
        with trace.span("restore.propagate", (clip, branch), branch=branch):
            model.propagate(feats, flows_backward if branch.startswith(
                "backward") else flows_forward, branch, runner.step)
    return lqs, feats


def graphs(model) -> StepGraphs:
    """``model``'s :class:`StepGraphs`, made on first use and kept while
    the model lives; each ask drops its captures where the weights they
    read have moved (:meth:`StepGraphs.check`)."""
    runner = _RUNNERS.get(model)
    if runner is None:
        runner = _RUNNERS[model] = StepGraphs(model)
    runner.check()
    return runner


def step_key(branch: str, prop: torch.Tensor) -> tuple:
    """The key of a branch step's graphs, read from its propagated
    features ``prop`` (B, H, W, C): (branch, B, H, W, C, dtype, device)."""
    return (branch, *prop.shape, prop.dtype, prop.device)


class StepGraphs:
    """A model's branch steps replayed from CUDA graphs, with the same
    arguments as ``BasicVSRPlusPlus.step``.

    A step engages the graphs where it is a second-order step of a CUDA
    tensor under inference mode; any other step runs the model's own
    ``step`` eagerly.  The captures of a clip size, (B, H, W, C, dtype,
    device), share one memory pool; the sizes of the last
    :data:`MAX_SIZES` clips are kept and an older one is dropped, its pool
    with it.  The graphs read the weights where they lay at capture, so
    :meth:`check` drops every capture once a branch's weights have moved (a
    cast, a device move, a new tensor)."""

    def __init__(self, model):
        self._model = weakref.ref(model)   # the model holds no runner
        self.sizes = OrderedDict()   # size -> (pool, {branch: _Captured})
        self._weights = None

    def check(self) -> None:
        """Drop every capture where the branches' weights have moved since
        the captures were taken."""
        model = self._model()
        weights = tuple(p.data_ptr() for m in (model.deform_align,
                                               model.backbone)
                        for p in m.parameters())
        if weights != self._weights:
            self.drop()
            self._weights = weights

    def step(self, module, prop, current, others, flow_n1=None,
             feat_n2=None, flow_prev=None):
        model = self._model()
        args = (module, prop, current, others, flow_n1, feat_n2, flow_prev)
        if (feat_n2 is None or not prop.is_cuda
                or not torch.is_inference_mode_enabled()):
            trace.count("restore.graph", 0)
            return model.step(*args)
        size = step_key(module, prop)[1:]
        with torch.cuda.device(prop.device):
            captured = self.sizes.get(size, (None, {}))[1].get(module)
            if captured is not None:
                self.sizes.move_to_end(size)
                trace.count("restore.graph", 1)
                return captured.run(*args[1:])
            out = model.step(*args)       # the warm-up before the capture
            trace.count("restore.graph", 0)
            if size not in self.sizes:
                while len(self.sizes) >= MAX_SIZES:
                    _sync(next(iter(self.sizes)))   # none left in flight
                    self.sizes.popitem(last=False)
                self.sizes[size] = (torch.cuda.graph_pool_handle(), {})
            pool, group = self.sizes[size]
            group[module] = _Captured(model, module, pool, *args[1:])
        return out

    def drop(self) -> None:
        """Drop every capture and its memory."""
        for size in self.sizes:
            _sync(size)
        self.sizes.clear()


def _sync(size: tuple) -> None:
    """Wait for the device of a clip size's captures to finish."""
    if size[-1].type == "cuda":
        torch.cuda.synchronize(size[-1])


def _capture(pool, fn):
    """(a CUDA graph of ``fn``'s launches, ``fn``'s result), captured on a
    side stream into memory pool ``pool``.  Unlike ``torch.cuda.graph`` it
    neither synchronizes the device nor empties the allocators' caches
    (the download's pinned blocks among them), so a capture in the middle
    of a restore costs it little."""
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
    return graph, out


class _Captured:
    """One branch step's two graphs at one key, and their static buffers.

    Each step's inputs are staged by device copies (~6 feature maps a
    step: the frame's, the output two steps back, the earlier branches',
    the DCN's output and the step's own output; the previous step's output
    is already in place after a replay).  Segment A's graph reads the
    staged inputs and leaves the DCN's input and offsets in its pool;
    segment B's writes the step's output into the staged ``prop``, which
    the next step's segment A reads."""

    def __init__(self, model, module, pool, prop, current, others, flow_n1,
                 feat_n2, flow_prev):
        self.deform = model.deform_align[module].deform
        self.prop, self.cur, self.n2, self.f1, self.f0 = (
            t.clone() for t in (prop, current, feat_n2, flow_n1, flow_prev))
        self.others = [t.clone() for t in others]
        self.aligned = torch.empty_like(prop)
        self.a, (self.x, self.om) = _capture(pool, lambda: model.align_input(
            module, self.prop, self.cur, self.f1, self.n2, self.f0))
        self.b, _ = _capture(pool, lambda: model.backbone_step(
            module, self.cur, self.others, self.aligned, out=self.prop))
        self.last = None              # the output this replayed last

    def run(self, prop, current, others, flow_n1, feat_n2, flow_prev):
        if prop is not self.last:
            self.prop.copy_(prop)
        for dst, src in zip((self.cur, self.n2, self.f1, self.f0,
                             *self.others),
                            (current, feat_n2, flow_n1, flow_prev, *others)):
            dst.copy_(src)
        self.a.replay()
        # The DCN runs eagerly between the graphs: the benchmark reads the
        # DCN's roofline from its calls of ``dcn_fwd_om`` and the device
        # ops launched inside them, which a replayed DCN would bypass.  It
        # can move into segment A's graph once the DCN's work is read from
        # the model's shapes instead.
        self.aligned.copy_(self.deform(self.x, self.om))
        self.b.replay()
        self.last = self.prop.clone()
        return self.last
