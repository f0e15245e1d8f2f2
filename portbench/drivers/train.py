"""``train_split``-style traffic: the recipe's training steps through the
port's ``Trainer``, on its own loader over seeded synthetic clips.

Set-up makes the train set in memory (:class:`Pool`: seeded samples made
on the card, held on the host), builds one ``Trainer`` (the recipe's Split
loss, augmentation and Adam; the traffic's precision and DCN clamp) whose
loader, built by the port's ``create_dataloader`` with the recipe's
workers and batch, reads that set; loads the configuration's seeded weights
into its model (``strict``) and gives it an augmentation generator made
from the seed.  It then drives that same
object through its first ``checked_steps`` steps with the window's own
feed (the loader's next batch, the upload, ``train_step``), keeping what
the check needs: each step's batch and losses, the first gradient (from
Adam's first moment after one step) and the parameters' change after the
last of them.  Those steps are the warm-up; the window goes on with the
same iterator.

The window drives exactly what ``Trainer.train``'s loop does each step,
with no logging, validation or checkpoint, and ends in a synchronize.

The check, once the window has closed and the Trainer is freed, runs the
plain reference (``reference/split.py``) from the same weights through the
same batches and augmentation draws, and compares each step's loss, the
first gradient's norm per parameter and the change's norm per parameter.
"""
from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import torch
import torch.nn.functional as F

from portbench.harness import ROOT, Outcome, Readings
from portbench.reference import family, split
from portbench.reference.precision import strict_fp32
from portbench.weights import make_params

LOSSES = ("l_pix_y", "l_pix_c", "l_pix")


class Pool:
    """The train set: ``pool_samples`` samples of the model's frames at the
    crop size, made on the card from the seed in a few large calls and held
    on the host as the loader's data set (``get`` hands out views; the
    loader's collate copies them into the batch).  GT: smooth texture (a
    coarse and a fine octave of seeded noise, resized bicubically) at a
    contrast and level drawn per sample, as scenes differ, panning 1-4 px a
    frame in a direction drawn per sample; LQ: its 3x3 box blur plus
    Gaussian noise of std ``noise``, clipped to [0, 1]."""

    def __init__(self, seed: int, tr: dict, nframes: int, device):
        n, size = tr["pool_samples"], tr["crop"]
        lo, hi = tr["motion_px"]
        pad = math.ceil(hi * (nframes - 1) / 2) + 2
        side = size + 2 * pad
        gen = torch.Generator(device=device).manual_seed(seed)
        tex = 0
        for cell, amp in ((16, 0.7), (4, 0.3)):
            noise = torch.rand(n, 3, side // cell + 4, side // cell + 4,
                               generator=gen, device=device)
            tex = tex + amp * F.interpolate(noise, size=(side, side),
                                            mode="bicubic",
                                            align_corners=False)
        lo_c, hi_c = tr["contrast"]
        contrast, level, speed, angle = torch.rand(4, n, generator=gen,
                                                   device=device)
        contrast = (lo_c + (hi_c - lo_c) * contrast)[:, None, None, None]
        tex = level[:, None, None, None] * (1 - contrast) \
            + contrast * tex.clamp(0, 1)
        speed = lo + (hi - lo) * speed
        vel = torch.stack([speed * torch.sin(2 * math.pi * angle),
                           speed * torch.cos(2 * math.pi * angle)], 1)
        half = (nframes - 1) / 2
        at = (pad + torch.round(vel[:, None] * (
            torch.arange(nframes, device=device)[None, :, None] - half))
              ).long().tolist()
        gt = torch.stack([torch.stack([tex[i, :, y:y + size, x:x + size]
                                       for y, x in at[i]])
                          for i in range(n)])        # (n, T, 3, H, W)
        lq = F.avg_pool2d(gt.flatten(0, 1), 3, 1, 1,
                          count_include_pad=False).view_as(gt)
        lq = (lq + tr["noise"] * torch.randn(lq.shape, generator=gen,
                                             device=device)).clamp(0, 1)
        self.gt = gt.permute(0, 1, 3, 4, 2).contiguous().cpu().numpy()
        self.lq = lq.permute(0, 1, 3, 4, 2).contiguous().cpu().numpy()

    def __len__(self) -> int:
        return len(self.gt)

    def get(self, index: int, rng) -> dict:
        return {"LQs": self.lq[index], "GT": self.gt[index],
                "key": str(index)}


def trainer_opt(cfg: dict, tr: dict, seed: int, root: str) -> dict:
    """The options ``Trainer`` takes, as ``core.config.parse`` returns
    them: the recipe of the configuration, the traffic's batch and workers
    (over a stand-in ``Synthetic`` set that :func:`setup` replaces by the
    :class:`Pool`), and no validation, logging to disk or checkpoint."""
    net = cfg["network_G"]
    data = {"name": "Pool_Train", "mode": "Synthetic", "phase": "train",
            "scale": cfg["scale"], "N_frames": net["nframes"],
            "GT_size": tr["crop"], "batch_size": tr["batch_size"],
            "n_workers": tr["n_workers"], "dataset_ratio": 1}
    train = dict(cfg["train"], manual_seed=seed, val_freq=None,
                 mixed_precision=tr["dtype"] == "bfloat16")
    return {"name": "portbench", "model": cfg["model"], "scale": cfg["scale"],
            "is_train": True, "use_tb_logger": False,
            "datasets": {"train": data}, "network_G": dict(net),
            "path": {"root": root}, "train": train, "augment": cfg["augment"],
            "logger": {"print_freq": 10 ** 9,
                       "save_checkpoint_freq": 10 ** 9}}


class Feed:
    """The Trainer's batches, epoch after epoch from ``epoch``, as
    ``Trainer.train`` takes them."""

    def __init__(self, loader, epoch: int):
        self.loader, self.epoch = loader, epoch
        self.it = loader.epoch_iter(epoch)

    def next(self) -> dict:
        try:
            return next(self.it)
        except StopIteration:
            self.epoch += 1
            self.it = self.loader.epoch_iter(self.epoch)
            return next(self.it)

    def close(self) -> None:
        self.it.close()


def step(ctx, trainer, feed: Feed, waits=None):
    """One step of ``Trainer.train``'s loop; returns (host batch, logs)."""
    t = time.perf_counter()
    with ctx.span("loader_wait"):
        batch = feed.next()
    if waits is not None:
        waits.append(time.perf_counter() - t)
    with ctx.span("upload"):
        device_batch = {k: torch.from_numpy(batch[k]).to(trainer.device)
                        for k in ("LQs", "GT")}
    with ctx.span("train_step"):
        trainer.state, logs = trainer.train_step(trainer.state, device_batch,
                                                 trainer.gen)
    return batch, logs


def _norms(tensors: dict) -> dict:
    return {k: v.detach().float().norm().item() for k, v in tensors.items()}


def setup(ctx, cfg, tr):
    """(trainer, feed, initial params, what the check needs) after the
    checked steps."""
    from realvsr_tpu_torch.data import create_dataloader
    from realvsr_tpu_torch.train.trainer import Trainer

    dev, net = ctx.device, cfg["network_G"]
    if dev.type == "cuda":
        from realvsr_tpu_torch.ops.kernels import _build

        _build.build(cfg["kernel_sources"])
    params = make_params(family(cfg["reference"]).param_specs(net), ctx.seed,
                         dev, torch.float32, cfg["offset_gain"])
    opt = trainer_opt(cfg, tr, ctx.seed, str(ROOT))
    trainer = Trainer(opt, device=dev, dcn_max_offset=tr["dcn_max_offset"])
    trainer.train_loader = create_dataloader(
        Pool(ctx.seed + 2, tr, net["nframes"], dev),
        opt["datasets"]["train"], opt)
    trainer.model.load_state_dict(params, strict=True)
    trainer.gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    feed = Feed(trainer.train_loader, ctx.seed % 1000)
    named = dict(trainer.model.named_parameters())
    seen = {"batches": [], "losses": []}
    for s in range(tr["checked_steps"]):
        batch, logs = step(ctx, trainer, feed)
        seen["batches"].append({k: batch[k] for k in ("LQs", "GT")})
        seen["losses"].append({k: logs[k].item() for k in LOSSES})
        if s == 0:   # the first gradient, from Adam's first moment
            b1 = float(cfg["train"]["beta1"])
            st = trainer.state.optimizer.state
            seen["grad_t"] = {k: (st[p]["exp_avg"] / (1 - b1)).cpu()
                              for k, p in named.items()}
            seen["grad"] = {k: v.norm().item()
                            for k, v in seen["grad_t"].items()}
    seen["change"] = {k: (p.detach() - params[k]).norm().item()
                      for k, p in named.items()}
    rows = {hashlib.sha1(b[k][i].tobytes()).digest()
            for b in seen["batches"] for k in ("LQs",)
            for i in range(len(b[k]))}
    if len(rows) != tr["checked_steps"] * tr["batch_size"]:
        raise RuntimeError("the checked steps' rows repeat: the traffic "
                           "needs more distinct samples")
    return trainer, feed, params, seen


def reference(cfg, tr, params, seen, seed, device,
              rows: slice = slice(None)) -> dict:
    """The plain reference through the checked steps, in float32: {"losses":
    [...], "grad": {name: norm}, "change": {name: norm}}.  ``rows`` keeps
    part of each batch (a fault a check has to catch)."""
    strict_fp32()
    net, recipe = cfg["network_G"], cfg["train"]
    p0 = params
    p = {k: v.clone().requires_grad_() for k, v in p0.items()}
    adam = split.Adam(p, recipe)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    out = {"losses": []}
    for s, batch in enumerate(seen["batches"]):
        lq = torch.from_numpy(batch["LQs"]).to(device)
        gt = torch.from_numpy(batch["GT"]).to(device)
        gt, lq = split.augment(gen, gt, lq, cfg["augment"])
        l_y, l_c = split.loss_and_grads(
            net, p, lq[rows], gt[rows], recipe, tr["dcn_max_offset"],
            tr["reference_block"])
        out["losses"].append({"l_pix_y": l_y, "l_pix_c": l_c,
                              "l_pix": l_y + l_c})
        if s == 0:
            out["grad"] = _norms({k: v.grad for k, v in p.items()})
            out["grad_t"] = {k: v.grad.detach().cpu() for k, v in p.items()}
        adam.step()
    out["change"] = _norms({k: p[k] - p0[k] for k in p})
    return out


def _left_out(grad: dict) -> list[str]:
    """Parameters whose reference gradient is under a thousandth of the
    median parameter's: Adam moves them by round-off alone."""
    med = float(np.median(list(grad.values())))
    return [k for k, v in grad.items() if v < 1e-3 * med]


def compare(got: dict, ref: dict) -> dict:
    """The numbers of the check.  ``loss1_gap``: the relative gap of the
    first step's loss (the forward and the loss alone, before any update);
    ``loss_gap``: the worst step's.  ``grad_gap`` and ``change_gap``: by the worst
    parameter, the gap between the two sides' norms of the first gradient
    and of the change after the checked steps, over the larger of that
    parameter's reference norm and the median parameter's; the change
    leaves out :func:`_left_out`'s parameters.  ``grad_diff``: the median
    parameter's ‖g − g_ref‖ / ‖g_ref‖ of the first gradient (how far its
    direction and size moved, not only its norm)."""
    gaps = [abs(g["l_pix"] - r["l_pix"]) / abs(r["l_pix"])
            for g, r in zip(got["losses"], ref["losses"])]
    med_g = float(np.median(list(ref["grad"].values())))
    grad = max(abs(got["grad"][k] - v) / max(v, med_g)
               for k, v in ref["grad"].items())
    moved = [k for k in ref["grad"] if k not in _left_out(ref["grad"])]
    med_c = float(np.median([ref["change"][k] for k in moved]))
    change = max(abs(got["change"][k] - ref["change"][k])
                 / max(ref["change"][k], med_c) for k in moved)
    diff = float(np.median([
        ((got["grad_t"][k] - g).norm() / g.norm().clamp_min(1e-30)).item()
        for k, g in ref["grad_t"].items()]))
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "grad_gap": grad,
            "grad_diff": diff, "change_gap": change}


def run(ctx) -> Outcome:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev = ctx.device
    trainer, feed, params, seen = setup(ctx, cfg, tr)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    waits, steps = [], 0
    with ctx.window():
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        ends = [t0]
        while True:
            step(ctx, trainer, feed, waits)
            steps += 1
            ends.append(time.perf_counter())
            if ends[-1] >= deadline:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    feed.close()
    del trainer, feed
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference(cfg, tr, params, seen, ctx.seed, dev)
    got = compare(seen, ref)
    # a number without a limit (limits/<cell>.json) is read, not compared
    host_ms = sorted(1e3 * (b - a) for a, b in zip(ends, ends[1:]))
    extra = {"not_compared": {k: v for k, v in got.items()
                              if k not in ctx.cell.limits},
             "step_host_ms": [host_ms[0], host_ms[len(host_ms) // 2],
                              host_ms[-1]],
             "wait_ms": [1e3 * min(waits), 1e3 * max(waits)],
             "change_left_out": _left_out(ref["grad"])}
    if ctx.controls:   # a fault: half of each batch left out of the mean
        half = slice(0, tr["batch_size"] // 2)
        extra["half_batch"] = compare(
            reference(cfg, tr, params, seen, ctx.seed, dev, rows=half), ref)
    net = cfg["network_G"]
    shape = (tr["batch_size"], net["nframes"], tr["crop"], tr["crop"], 3)
    flops = 3 * family(cfg["reference"]).model_flops(net, shape)
    lim = ctx.cell.limits
    return Outcome(
        attempted=steps, failed=0,
        metrics={"samples_per_s": steps * tr["batch_size"] / secs},
        checks={k: (v, lim[k]) for k, v in got.items() if k in lim},
        memory_peak_bytes=peak,
        readings=Readings(window_s=secs, units=steps, flops_per_unit=flops,
                          dtype=tr["dtype"],
                          host_spans={"loader_wait": waits}),
        extra=extra)
