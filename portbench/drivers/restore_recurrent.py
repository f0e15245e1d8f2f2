"""``restore_reds4``-style traffic: one caller restoring whole clips in a
closed loop through the port's restore entry (``tools/_cli.py::restorer``,
which runs a recurrent model over each clip: ``eval/recurrent.py``), as
``tools/test_wo_gt.py`` restores a folder.

Set-up builds the model through ``define_g`` at the traffic's precision
(first, so a port without the model fails before anything is compiled),
makes the configuration's weights on the device from the seed with each
SPyNet level's last conv scaled by ``spynet_gain`` and each alignment's
DCN weight by ``dcn_gain`` (:func:`make_weights`; the configuration's
``assumed`` says why), loads them (``strict``), and makes a pool of clips
(``drivers/restore.py::make_clips``).  It warms up by restoring the first
clip whole.

The window is the sliding-window cells' (``drivers/restore.py::window``):
it cycles through the pool asking for one frame at a time and keeps a
seeded sample of the frames handed back.  Once the window has closed, the
plain reference runs over each whole clip that holds a sampled frame
(frame t needs the backward branches over the clip) and ``frame_gap`` is
the restore cells': the worst sampled frame's rms(out - reference) over
rms(the reference's residual).
"""
from __future__ import annotations

import argparse
from collections import defaultdict

import numpy as np
import torch

from portbench.drivers.restore import DTYPES, Sample, make_clips, window
from portbench.harness import Outcome, Readings
from portbench.reference import family
from portbench.reference.precision import Precision, strict_fp32
from portbench.weights import make_params

def _gain(cfg: dict, name: str) -> float:
    """The driver's extra scale of parameter ``name``: ``spynet_gain`` on
    each SPyNet level's last conv (the flow residue it adds), ``dcn_gain``
    on each alignment's DCN weight."""
    if name.startswith("spynet.") and ".basic_module.4.conv." in name:
        return cfg["spynet_gain"]
    if name.startswith("deform_align.") and name.endswith(".weight") \
            and ".conv_offset." not in name:
        return cfg["dcn_gain"]
    return 1.0


def make_weights(cfg: dict, seed: int, device, dtype,
                 net: dict | None = None) -> dict:
    """The state dict of the configuration's network (or of ``net``) drawn
    from ``seed`` (``portbench/weights.py``), the gains of the
    configuration's ``assumed`` applied, SPyNet's mean and std beside."""
    ref = family(cfg["reference"])
    params = make_params(ref.param_specs(net or cfg["network_G"]), seed,
                         device, dtype, cfg["offset_gain"])
    params = {k: v * _gain(cfg, k) for k, v in params.items()}
    params.update({k: v.to(dtype) for k, v in ref.buffers(device).items()})
    return params


def setup(ctx, cfg: dict, tr: dict):
    """(params, restore, clips) of the cell at ``ctx.seed``."""
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.tools import _cli

    dev, net = ctx.device, cfg["network_G"]
    dtype = DTYPES[tr["dtype"]]
    opt = {"network_G": net, "scale": cfg["scale"], "datasets": {"test": {}}}
    model = define_g(opt, device=dev, dtype=dtype,
                     dcn_max_offset=tr["dcn_max_offset"])
    if dev.type == "cuda":
        from realvsr_tpu_torch.ops.kernels import _build

        _build.build(cfg["kernel_sources"])
    params = make_weights(cfg, ctx.seed, dev, dtype)
    model.load_state_dict(params, strict=True)
    args = argparse.Namespace(streaming=False, flip_test=False, tile=None,
                              overlap=0)
    restore = _cli.restorer(args, opt, model)
    h, w = cfg["restore_size"]
    clips = make_clips(ctx.seed + 2, tr, h, w, dev)   # apart from the weights
    return params, restore, clips


def gaps(cfg, params, clips, sample, device,
         precisions=(("program", None),)) -> dict:
    """{name: [gap per sampled frame]}: rms(got - reference) / rms(the
    reference's residual), where got is the program's output ("program")
    or the reference in a lower precision (a :class:`Precision`), the
    reference run once over each clip that holds a sampled frame."""
    strict_fp32()
    ref = family(cfg["reference"])
    net = cfg["network_G"]
    p32 = {k: v.float() for k, v in params.items()}
    by_clip = defaultdict(list)
    for clip, idx, got in sample.frames():
        by_clip[clip].append((idx, got))
    out = {name: [] for name, _ in precisions}
    for clip, kept in by_clip.items():
        x = torch.from_numpy(clips[clip]).to(device)[None]
        idxs = [idx for idx, _ in kept]
        with torch.no_grad():
            want, res = ref.forward(net, p32, x, frames=idxs)
            lower = {name: ref.forward(net, p32, x, prec, frames=idxs)[0]
                     for name, prec in precisions if prec is not None}
        for j, (_, got) in enumerate(kept):
            scale = res[0, j].pow(2).mean().sqrt()
            for name, prec in precisions:
                y = (torch.from_numpy(got).to(device) if prec is None
                     else lower[name][0, j].permute(1, 2, 0))
                diff = y - want[0, j].permute(1, 2, 0)
                out[name].append((diff.pow(2).mean().sqrt() / scale).item())
        del want, res, lower
    return out


def run(ctx) -> Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    params, restore, clips = setup(ctx, cfg, tr)
    for _ in range(tr["warmup_clips"]):
        for _ in restore(clips[0]):
            pass
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    h, w = cfg["restore_size"]
    out_shape = (h * cfg["scale"], w * cfg["scale"], 3)
    sample = Sample(tr["check_frames"], ctx.seed, tr["frames_per_clip"],
                    out_shape)
    with ctx.window():
        lat, bad, secs = window(ctx, restore, clips, tr, sample, out_shape)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del restore
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    precs = [("program", None)]
    if ctx.controls:   # the reference in fp8, the precision below bf16
        precs.append(("fp8", Precision(fp8=True)))
    got = gaps(cfg, params, clips, sample, dev, precs)
    g = got["program"]
    ref = family(cfg["reference"])
    flops = ref.model_flops(cfg["network_G"],
                            (1, tr["frames_per_clip"], h, w, 3))
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
