"""``restore_clips``-style traffic: one caller restoring clips in a closed
loop through the port's restore entry (``tools/_cli.py::restorer``), as
``tools/test_wo_gt.py`` restores a folder.

Set-up makes the configuration's weights on the device from the seed,
builds the model through ``define_g`` at the traffic's precision and DCN
clamp, loads the weights (``strict``), and makes a pool of clips: smooth
texture (a coarse and a fine octave of seeded noise, resized bicubically)
panning at a speed and in a direction drawn per clip, every clip of the
same size.  It warms up by restoring the first frames of a clip.

The window cycles through the pool, asking the restore iterator for one
frame at a time, and times each frame from the ask to holding its float32
output.  A seeded sample of the frames handed back (the window's first
frame and the first clip's last, both padded windows, and a reservoir of
the rest) is kept and, once the window has closed, compared with the plain
reference run on the same frames.
"""
from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import Outcome, Readings
from portbench.reference import family
from portbench.reference.precision import Precision, strict_fp32
from portbench.weights import make_params

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def make_clips(seed: int, tr: dict, h: int, w: int, device) -> list:
    """``tr["clips"]`` clips of (T, H, W, 3) float32 frames in [0, 1]."""
    t_len = tr["frames_per_clip"]
    lo, hi = tr["motion_px"]
    pad = math.ceil(hi * (t_len - 1) / 2) + 2
    ch, cw = h + 2 * pad, w + 2 * pad
    gen = torch.Generator(device=device).manual_seed(seed)
    clips = []
    for _ in range(tr["clips"]):
        speed, angle = torch.rand(2, generator=gen, device=device).tolist()
        speed = lo + (hi - lo) * speed
        vy = speed * math.sin(2 * math.pi * angle)
        vx = speed * math.cos(2 * math.pi * angle)
        tex = 0
        for cell, amp in ((16, 0.7), (4, 0.3)):
            noise = torch.rand(1, 3, ch // cell + 4, cw // cell + 4,
                               generator=gen, device=device)
            tex = tex + amp * F.interpolate(noise, size=(ch, cw),
                                            mode="bicubic",
                                            align_corners=False)
        tex = tex.clamp(0, 1)[0]
        frames = []
        for t in range(t_len):
            y = pad + round(vy * (t - (t_len - 1) / 2))
            x = pad + round(vx * (t - (t_len - 1) / 2))
            frames.append(tex[:, y:y + h, x:x + w])
        clips.append(torch.stack(frames).permute(0, 2, 3, 1))
    return list(torch.stack(clips).cpu().numpy())


def window_indices(i: int, n: int, nframes: int) -> list[int]:
    """The frames of the window centred on frame ``i`` of ``n``, replicate
    padding at the ends."""
    half = nframes // 2
    return [min(max(j, 0), n - 1) for j in range(i - half, i + half + 1)]


class Sample:
    """The frames kept for the check: the window's first frame, the first
    clip's last frame, and a seeded reservoir of ``k`` of the rest.

    A kept frame is copied into a buffer made (and written) at set-up, so
    the program's own output array is released as any other frame's: a
    kept array would make the next frame's download fault in fresh pages,
    a cost the loop would add to the frames it samples."""

    def __init__(self, k: int, seed: int, t_len: int, shape):
        self.k, self.t_len = k, t_len
        self.rng = np.random.default_rng(seed)
        self.buf = np.ones((k + 2, *shape), np.float32)
        self.meta = [None] * (k + 2)
        self.seen = 0

    def _keep(self, slot: int, clip: int, idx: int, out) -> None:
        np.copyto(self.buf[slot], out)
        self.meta[slot] = (clip, idx)

    def offer(self, n: int, clip: int, idx: int, out: np.ndarray) -> None:
        if n == 0 or (n == self.t_len - 1 and idx == self.t_len - 1):
            self._keep(0 if n == 0 else 1, clip, idx, out)
            return
        self.seen += 1
        j = self.seen - 1 if self.seen <= self.k else int(
            self.rng.integers(0, self.seen))
        if j < self.k:
            self._keep(2 + j, clip, idx, out)

    def frames(self) -> list:
        return [(*m, self.buf[i]) for i, m in enumerate(self.meta)
                if m is not None]


def _with_forward_span(ctx, build):
    """``build()`` (the restorer) with each window's model forward inside
    a ``pb.forward`` span of a traced window, so the timeline can tell the
    host launching the forward from the rest of a frame (gathering its
    window, the download)."""
    from realvsr_tpu_torch.tools import _cli

    inner = _cli.make_forward

    def make_forward(model, params=None):
        fwd = inner(model, params)

        def spanned(window):
            with ctx.span("forward"):
                return fwd(window)
        return spanned

    _cli.make_forward = make_forward
    try:
        return build()
    finally:
        _cli.make_forward = inner


def setup(ctx, cfg: dict, tr: dict):
    """(params, model, restore, clips) of the cell at ``ctx.seed``."""
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.tools import _cli

    dev, net = ctx.device, cfg["network_G"]
    if dev.type == "cuda":
        from realvsr_tpu_torch.ops.kernels import _build

        _build.build(cfg["kernel_sources"])
    ref = family(cfg["reference"])
    dtype = DTYPES[tr["dtype"]]
    params = make_params(ref.param_specs(net), ctx.seed, dev, dtype,
                         cfg["offset_gain"])
    opt = {"network_G": net, "scale": cfg["scale"],
           "datasets": {"test": {"padding": "replicate"}}}
    model = define_g(opt, device=dev, dtype=dtype,
                     dcn_max_offset=tr["dcn_max_offset"])
    model.load_state_dict(params, strict=True)
    args = argparse.Namespace(streaming=False, flip_test=False, tile=None,
                              overlap=0)
    restore = _with_forward_span(ctx, lambda: _cli.restorer(args, opt, model))
    h, w = cfg["restore_size"]
    clips = make_clips(ctx.seed + 2, tr, h, w, dev)   # apart from the weights
    return params, model, restore, clips


def window(ctx, restore, clips, tr, sample: Sample, out_shape):
    """The measured loop: (frame latencies, frames handed back with a wrong
    index or shape, seconds)."""
    t_len = tr["frames_per_clip"]
    lat, bad, n = [], 0, 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    c, done, t1 = 0, False, t0
    while not done:
        clip = c % len(clips)
        frames = restore(clips[clip])
        for k in range(t_len):
            a = time.perf_counter()
            with ctx.span("frame"):
                idx, out = next(frames)
            t1 = time.perf_counter()
            lat.append(t1 - a)
            bad += idx != k or out.shape != out_shape
            sample.offer(n, clip, idx, out)
            n += 1
            if t1 >= deadline:
                done = True
                break
        frames.close()
        c += 1
    return lat, bad, t1 - t0


def gaps(cfg, tr, params, clips, sample, device,
         precisions=(("program", None),)) -> dict:
    """{name: [gap per sampled frame]}: rms(got - reference) / rms(the
    reference's residual), where got is the program's output ("program")
    or the reference in a lower precision (a :class:`Precision`)."""
    strict_fp32()
    ref = family(cfg["reference"])
    net = cfg["network_G"]
    p32 = {k: v.float() for k, v in params.items()}
    out = {name: [] for name, _ in precisions}
    for clip, idx, got in sample.frames():
        sel = window_indices(idx, tr["frames_per_clip"], net["nframes"])
        x = torch.from_numpy(clips[clip][sel]).to(device)[None]
        with torch.no_grad():
            want, res = ref.forward(net, p32, x, tr["dcn_max_offset"])
            scale = res.pow(2).mean().sqrt()
            for name, prec in precisions:
                if prec is None:
                    y = torch.from_numpy(got).to(device)
                else:
                    y = ref.forward(net, p32, x, tr["dcn_max_offset"],
                                    prec)[0][0].permute(1, 2, 0)
                diff = y - want[0].permute(1, 2, 0)
                out[name].append((diff.pow(2).mean().sqrt() / scale).item())
    return out


def run(ctx) -> Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    params, model, restore, clips = setup(ctx, cfg, tr)
    h, w = cfg["restore_size"]
    warm = restore(clips[0])
    for _ in range(tr["warmup_frames"]):
        next(warm)
    warm.close()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    out_shape = (h * cfg["scale"], w * cfg["scale"], 3)
    sample = Sample(tr["check_frames"], ctx.seed, tr["frames_per_clip"],
                    out_shape)
    with ctx.window():
        lat, bad, secs = window(ctx, restore, clips, tr, sample, out_shape)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del restore, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    precs = [("program", None)]
    if ctx.controls:   # the reference in fp8, the precision below bf16
        precs.append(("fp8", Precision(fp8=True)))
    got = gaps(cfg, tr, params, clips, sample, dev, precs)
    g = got["program"]
    ref = family(cfg["reference"])
    flops = ref.model_flops(cfg["network_G"],
                            (1, cfg["network_G"]["nframes"], h, w, 3))
    lim = ctx.cell.limits
    return Outcome(
        attempted=len(lat), failed=int(bad),
        metrics={"frames_per_s": len(lat) / secs},
        checks={"frame_gap": (max(g), lim["frame_gap"])},
        memory_peak_bytes=peak,
        readings=Readings(window_s=secs, units=len(lat),
                          flops_per_unit=flops, dtype=tr["dtype"],
                          host_spans={"frame": lat}),
        extra={"checked_frames": len(g),
               "frame_ms": [1e3 * float(np.percentile(lat, q))
                            for q in (5, 50, 75, 90, 95, 100)],
               **{f"{k}_frame_gap": max(v) for k, v in got.items()
                  if k != "program"}})
