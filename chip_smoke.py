#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``realvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the two paths from ``realvsr_tpu_torch/csrc`` with
   nvcc, in parallel, and print ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes, in bf16 and f32, with the tolerances of
   ``realvsr_tpu_torch/ops/kernels/check.py``: the DCN forward and the
   conv3x3 at the inference shapes, the DCN backward at one training sample
   (3, 192, 192, 64) clamped to ±8 and exact, with offsets of a few pixels
   (taps outside the image) and with zero offsets, each of dx, doffset,
   dmask and dW on its own; and the conv3x3 autograd, with and without
   an activation, against autograd of its plain version;
4. inference: EDVR_NoUp at full width (nf 64, 3 frames, 8 deformable
   groups, 5 + 10 ResBlocks, no TSA, DCN offsets clamped to ±4 as the JAX
   package's deployment setting), bf16, seeded random weights with
   randomised DCN offset convs, through ``evaluate_wo_gt`` on a seeded
   synthetic 5-frame 1024x512 PNG clip, with the kernels' launch counts
   read around that run; then the same weights at 64x128 on the card (f32
   and bf16) against the CPU in f32;
5. training: the port's ``Trainer`` on the Split recipe
   (``configs/train/train_EDVR_woTSA_RealVSR_YCbCr_Split.yml`` parsed as
   is; the train set swapped to the ``Synthetic`` mode at the recipe's
   192x192 crops, validation off, a few iterations; DCN clamp ±8 as the
   training command line's default), with the model's offset convs
   randomised before its loop, once in f32 and once with
   ``train.mixed_precision`` (bf16 activations, f32 parameters); per step
   the launch counts, finite losses and moved parameters are checked, and
   steps/s after warm-up, the device's idle time between steps and peak
   memory printed; then one full-width Split step at 64x64 on the card
   against the CPU in f32;
6. times: each kernel, its plain version and the one PyTorch call that
   computes the same function (where there is one) with CUDA events at the
   paths' shapes, and the inference slice's frames/s at 1024x512.

Prints one JSON line per check and timing, then the card line, the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
``--profile`` adds a ``torch.profiler`` breakdown of one window's forward.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, data sheet
PEAK_TC_FLOPS = {"bfloat16": 989e12, "float32": 495e12}  # dense bf16 / TF32
PEAK_F32_FLOPS = 67e12   # f32 outside the tensor cores
H, W, NFRAMES, CLIP = 512, 1024, 3, 5
RECIPE = os.path.join("configs", "train",
                      "train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
TRAIN_BATCH = 32                 # the recipe's; f32 fits it too (PERF.md)


def emit(**kv):
    print(json.dumps(kv), flush=True)


def train_r() -> float:
    """The DCN clamp of the training command line (its default)."""
    from realvsr_tpu_torch.tools.train import DCN_MAX_OFFSET

    return DCN_MAX_OFFSET


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(bytes_moved, tc_flops, f32_flops, dtype):
    """(least ms, "bytes" | "operations") from data-sheet peaks; the tensor
    cores and the f32 cores run at once, so the slower of the two counts."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = max(tc_flops / PEAK_TC_FLOPS[dtype], f32_flops / PEAK_F32_FLOPS)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dcn_inputs(shape, dtype, seed):
    import torch

    b, h, w, c = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    # ±4 px on the whole (std 2.5: some beyond the clamp), out-of-image
    # taps at every border
    off = torch.randn(b, h, w, 8 * 18, generator=g) * 2.5
    mask = torch.rand(b, h, w, 8 * 9, generator=g)
    wgt = (torch.rand(64, c, 3, 3, generator=g) * 2 - 1) / (9 * c) ** 0.5
    bias = torch.randn(64, generator=g) * 0.1
    return [t.to("cuda", dtype) for t in (x, off, mask, wgt, bias)]


def conv_inputs(shape, c2, residual, dtype, seed):
    import torch

    b, h, w, c1 = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c1, generator=g)
    x2 = torch.randn(b, h, w, c2, generator=g) if c2 else None
    wgt = (torch.rand(64, c1 + c2, 3, 3, generator=g) * 2 - 1) \
        / (9 * (c1 + c2)) ** 0.5
    bias = torch.randn(64, generator=g) * 0.1
    res = torch.randn(b, h, w, 64, generator=g) if residual else None
    return [None if t is None else t.to("cuda", dtype)
            for t in (x, x2, wgt, bias, res)]


DCN_CASES = [  # (name, shape, act): the L1 / cascade and the L3 DCNs
    ("L1", (3, H, W, 64), None),
    ("L3", (3, H // 4, W // 4, 64), "lrelu"),
]
CONV_CASES = [  # (name, shape, c2, act, residual)
    ("front 64->64 relu", (3, H, W, 64), 0, "relu", False),
    ("front 64->64 +res", (3, H, W, 64), 0, None, True),
    ("PCD L1 128->64 lrelu", (3, H, W, 64), 64, "lrelu", False),
]


def check_kernels():
    import torch

    from realvsr_tpu_torch.ops.kernels.check import max_abs_err, tolerance
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_plain
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd, dcn_fwd_plain

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, act in DCN_CASES:
            for r in (None, 4):
                args = dcn_inputs(shape, dtype, seed=1)
                out = dcn_fwd(*args, 8, act=act, max_offset=r)
                torch.cuda.synchronize()
                ref = dcn_fwd_plain(*args, 8, act, r)
                err, tol = max_abs_err(out, ref), tolerance(ref)
                emit(check="dcn_fwd", case=name, shape=shape, act=act,
                     max_offset=r, dtype=str(dtype)[6:], max_abs_err=err,
                     tol=tol)
                if not (err <= tol and torch.isfinite(out).all()):
                    raise AssertionError(f"dcn_fwd {name} {dtype} r={r}: "
                                         f"{err} > {tol}")
                errs[("dcn_fwd", name, dtype, r)] = err
                del out, ref, args
        for name, shape, c2, act, residual in CONV_CASES:
            x, x2, wgt, bias, res = conv_inputs(shape, c2, residual, dtype, 2)
            out = conv3x3(x, wgt, bias, act, res, x2)
            torch.cuda.synchronize()
            ref = conv3x3_plain(x, wgt, bias, act, res, x2)
            err, tol = max_abs_err(out, ref), tolerance(ref)
            emit(check="conv3x3", case=name, shape=shape, dtype=str(dtype)[6:],
                 max_abs_err=err, tol=tol)
            if not (err <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"conv3x3 {name} {dtype}: {err} > {tol}")
            errs[("conv3x3", name, dtype)] = err
            del out, ref, x, x2, res
    return errs


def dcn_bwd_inputs(shape, dtype, seed, zero_offsets=False):
    """x, offset, mask, weight, cotangent; offsets of std 2.5 px (taps
    outside the image at every border, some beyond ±8) or all zero (every
    position on the grid, as at the start of training)."""
    import torch

    b, h, w, c = shape
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    off = (torch.zeros(b, h, w, 8 * 18) if zero_offsets
           else torch.randn(b, h, w, 8 * 18, generator=g) * 2.5)
    mask = torch.rand(b, h, w, 8 * 9, generator=g)
    wgt = (torch.rand(64, c, 3, 3, generator=g) * 2 - 1) / (9 * c) ** 0.5
    gout = torch.randn(b, h, w, 64, generator=g)
    return [t.to("cuda", dtype) for t in (x, off, mask, wgt, gout)]


BWD_SHAPE = (3, 192, 192, 64)   # one training sample at the recipe's crop
TRAIN_L1 = (96, 192, 192, 64)   # L1 / cascade DCN of a batch-32 step


def check_backward():
    """The DCN backward kernel and the conv3x3 autograd on the card."""
    import torch

    from realvsr_tpu_torch.ops.kernels.check import (conv3x3_plain_grads,
                                                     grad_tolerance,
                                                     max_abs_err,
                                                     slope_mismatches)
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3_autograd
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_bwd, dcn_bwd_plain

    errs = {}
    names = ("dx", "doffset", "dmask", "dweight")
    for dtype in (torch.bfloat16, torch.float32):
        for r in (train_r(), None):
            for zero in (False, True):
                args = dcn_bwd_inputs(BWD_SHAPE, dtype, 3, zero)
                out = dcn_bwd(*args[:4], args[4], 8, r)
                torch.cuda.synchronize()
                ref = dcn_bwd_plain(*args[:4], args[4], 8, r)
                row = {}
                for name, o, rf in zip(names, out, ref):
                    err, tol = max_abs_err(o, rf), grad_tolerance(rf)
                    row[name] = dict(max_abs_err=err, tol=tol)
                    if not (o.dtype == rf.dtype and o.shape == rf.shape
                            and err <= tol and torch.isfinite(o).all()):
                        raise AssertionError(
                            f"dcn_bwd {name} {dtype} r={r} zero={zero}: "
                            f"{err} > {tol}")
                emit(check="dcn_bwd", shape=BWD_SHAPE, dtype=str(dtype)[6:],
                     max_offset=r, zero_offsets=zero, **row)
                errs[(dtype, r, zero)] = row
                del out, ref, args
    # conv3x3 autograd: each gradient within check.grad_tolerance of the
    # plain autograd with the slope taken from the kernel's output, and that
    # slope equal to the plain f32 one outside the rounding of 0 (check.py)
    g = torch.Generator().manual_seed(6)
    for dtype in (torch.bfloat16, torch.float32):
        for case, c2, act, residual in (
                ("64->64 +res", 0, None, True),
                ("128->64 two inputs", 64, None, False),
                ("64->64 relu", 0, "relu", False),
                ("128->64 lrelu two inputs", 64, "lrelu", False)):
            x, x2, wgt, bias, res = conv_inputs((3, 192, 192, 64), c2,
                                                residual, dtype, 7)
            leaves = [t.requires_grad_() for t in (x, wgt, bias, res, x2)
                      if t is not None]
            cot = torch.randn(3, 192, 192, 64, generator=g).to("cuda", dtype)
            out = conv3x3_autograd(x, wgt, bias, act, res, x2)
            ours = torch.autograd.grad(out, leaves, cot)
            ref = conv3x3_plain_grads(out, cot, leaves, x, wgt, bias, act,
                                      res, x2)
            names = ["dx", "dweight", "dbias"] + (
                ["dresidual"] if residual else []) + (["dx2"] if c2 else [])
            row = {}
            for name, o, rf in zip(names, ours, ref):
                err, tol = max_abs_err(o, rf), grad_tolerance(rf)
                row[name] = dict(max_abs_err=err, tol=tol)
                if not (err <= tol and torch.isfinite(o).all()):
                    raise AssertionError(f"conv3x3 autograd {case} {dtype} "
                                         f"{name}: {err} > {tol}")
            if act is not None:
                bad, near = slope_mismatches(out, x, wgt, bias, act, x2)
                row["slope"] = dict(mismatches=bad, left_out=near,
                                    of=out.numel())
                if bad:
                    raise AssertionError(f"conv3x3 autograd {case} {dtype}: "
                                         f"{bad} slopes differ")
            emit(check="conv3x3_autograd", case=case, dtype=str(dtype)[6:],
                 **row)
            del out, ours, ref, leaves
    return errs


def randomise_offset_convs(model, seed, std=1.0):
    """The DCN offset/mask convs are zero-initialised, so at init every
    offset is 0; random weights make the offsets reach a few pixels."""
    import torch

    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                p.copy_(torch.randn(p.shape, generator=g) * std)


def write_clip(root: str, seed: int) -> str:
    """A seeded 5-frame 1024x512 clip of smooth texture moving 3 px/frame."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.random((H // 8, W // 8 + 8, 3)).astype(np.float32),
                      (W + 64, H), interpolation=cv2.INTER_CUBIC)
    lq = os.path.join(root, "LQ", "000")
    os.makedirs(lq)
    for t in range(CLIP):
        frame = np.clip(base[:, 3 * t:3 * t + W] * 255, 0, 255)
        cv2.imwrite(os.path.join(lq, f"{t:05d}.png"), frame.astype(np.uint8))
    return os.path.dirname(lq)


def main_path(tmp):
    import cv2
    import numpy as np
    import torch

    from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt
    from realvsr_tpu_torch.models.edvr import EDVRNoUp
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_bwd, dcn_fwd

    cfg = dict(nf=64, nc=3, nframes=NFRAMES, groups=8, front_RBs=5,
               back_RBs=10, w_TSA=False, dcn_max_offset=4)
    model = EDVRNoUp(**cfg, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
    randomise_offset_convs(model, seed=1)
    lq_root = write_clip(tmp, seed=2)
    out_dir = os.path.join(tmp, "out")

    dcn_fwd.launches = dcn_bwd.launches = conv3x3.launches = 0
    res = evaluate_wo_gt(model, None, lq_root, n_frames=NFRAMES,
                         save_folder=out_dir)
    torch.cuda.synchronize()
    launches = {"dcn_fwd": dcn_fwd.launches, "conv3x3": conv3x3.launches,
                "dcn_bwd": dcn_bwd.launches}
    per_window = {k: v / CLIP for k, v in launches.items()}
    emit(phase="main_path", windows=CLIP, launches=launches,
         launches_per_window=per_window, frames_per_s_first_run=res[
             "frames_per_s"])
    if per_window["dcn_fwd"] < 4 or per_window["conv3x3"] < 41 or \
            launches["dcn_bwd"]:
        raise AssertionError(f"kernels not on the main path: {per_window}")
    saved = sorted(os.listdir(os.path.join(out_dir, "000")))
    if len(saved) != CLIP:
        raise AssertionError(f"expected {CLIP} outputs, got {saved}")
    for name in saved:
        img = cv2.imread(os.path.join(out_dir, "000", name))
        if img is None or img.shape != (H, W, 3):
            raise AssertionError(f"bad output {name}")

    # output checks on one window: finite, right shape, offsets in play
    frames = torch.from_numpy(np.stack([
        cv2.imread(os.path.join(lq_root, "000", f"{t:05d}.png"))[..., ::-1]
        .astype(np.float32) / 255 for t in range(NFRAMES)])).cuda()
    offs = []
    hooks = [m.conv_offset_mask.register_forward_hook(
        lambda mod, inp, out: offs.append(out[..., :out.shape[-1] * 2 // 3]))
        for m in model.modules() if hasattr(m, "conv_offset_mask")]
    with torch.inference_mode():
        y = model(frames[None].to(torch.bfloat16))
    for h in hooks:
        h.remove()
    if y.shape != (1, H, W, 3) or not torch.isfinite(y).all():
        raise AssertionError("main-path output not finite or misshapen")
    emit(phase="main_path_output", shape=list(y.shape),
         out_min=y.min().item(), out_max=y.max().item(),
         offset_abs_mean=[o.float().abs().mean().item() for o in offs],
         offset_abs_max=[o.float().abs().max().item() for o in offs])

    # the same weights at a reduced size: card (f32 and bf16) vs CPU f32.
    # f32: TF32 kernels through ~45 layers, 2e-2; bf16: 8-bit mantissas
    # through the same depth, 5e-2 (output range ~[0, 1]).
    sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
    cpu = EDVRNoUp(**cfg, device="cpu")
    cpu.load_state_dict(sd)
    card32 = EDVRNoUp(**cfg, device="cuda")
    card32.load_state_dict(sd)
    x = torch.rand(1, NFRAMES, 64, 128, 3,
                   generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        ref = cpu.eval()(x)
        for dtype, m, tol in ((torch.float32, card32.eval(), 2e-2),
                              (torch.bfloat16, model.eval(), 5e-2)):
            out = m(x.cuda().to(dtype)).float().cpu()
            err = (out - ref).abs().max().item()
            emit(phase="reduced_card_vs_cpu", dtype=str(dtype)[6:],
                 shape=list(x.shape), max_abs_err=err, tol=tol)
            if not (err <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"reduced {dtype}: {err} > {tol}")
    return model, lq_root, launches


def _train_opt(tmp, dtype):
    """The Split recipe as parsed, on the synthetic train set at its crop."""
    from realvsr_tpu_torch.core.config import parse

    opt = parse(os.path.join(ROOT, RECIPE), is_train=True,
                root=os.path.join(tmp, dtype))
    recipe = opt["datasets"]["train"]
    opt["datasets"] = {"train": dict(
        name="Synthetic_Train", mode="Synthetic", phase="train", scale=1,
        N_frames=recipe["N_frames"], GT_size=recipe["GT_size"],
        batch_size=TRAIN_BATCH, n_workers=recipe["n_workers"],
        num_seqs=8, frames_per_seq=10, dataset_ratio=20)}
    opt["train"].update(niter=TRAIN_STEPS, val_freq=None,
                        mixed_precision=dtype == "bfloat16")
    opt["logger"]["save_checkpoint_freq"] = 10 ** 9
    return opt


def training_slice(tmp, profile=False):
    """The training path through the port's Trainer, f32 and bf16.  With
    ``profile`` steps 4 and 5 of each run are traced (and so are not
    representative for the steps/s)."""
    import torch

    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_bwd, dcn_fwd
    from realvsr_tpu_torch.train.trainer import Trainer

    kernels = {"dcn_fwd": dcn_fwd, "dcn_bwd": dcn_bwd, "conv3x3": conv3x3}
    results, r = {}, train_r()
    # PyTorch's defaults, as the recipe runs: cuDNN convs in TF32, like the
    # kernels; the checks around this phase run cuDNN in full f32
    torch.backends.cudnn.allow_tf32 = True
    for dtype in ("float32", "bfloat16"):
        opt = _train_opt(tmp, dtype)
        trainer = Trainer(opt, device="cuda", dcn_max_offset=r)
        if profile:
            trainer.profile_steps = (TRAIN_STEPS - 2, TRAIN_STEPS)
        randomise_offset_convs(trainer.model, seed=11, std=0.5)
        before = {k: v.detach().clone()
                  for k, v in trainer.model.named_parameters()}
        steps = []
        inner = trainer.train_step

        def step(state, batch, gen, inner=inner):
            n0 = {k: f.launches for k, f in kernels.items()}
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            state, logs = inner(state, batch, gen)
            t1.record()
            steps.append(dict(
                launches={k: f.launches - n0[k] for k, f in kernels.items()},
                logs=logs, start=t0, end=t1))
            return state, logs

        trainer.train_step = step
        for f in kernels.values():
            f.launches = 0
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in kernels.items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if len(steps) != TRAIN_STEPS:
            raise AssertionError(f"{len(steps)} steps run, {TRAIN_STEPS} "
                                 "asked")
        for i, st in enumerate(steps):
            if st["launches"] != {"dcn_fwd": 4, "dcn_bwd": 4, "conv3x3": 41}:
                raise AssertionError(f"step {i}: launches {st['launches']}")
            if not all(torch.isfinite(v).item() for v in st["logs"].values()):
                raise AssertionError(f"step {i}: losses {st['logs']}")
        moved = sum(not torch.equal(before[k], v.detach())
                    for k, v in trainer.model.named_parameters())
        if moved != len(before):
            raise AssertionError(f"{len(before) - moved} parameters did not "
                                 "move")
        # steps after warm-up, start to end: the host loader is included.
        # The gaps between one step's end and the next one's start on the
        # device's clock are its idle time (batch upload and host waits).
        timed = steps[TRAIN_WARMUP:]
        ms = timed[0]["start"].elapsed_time(timed[-1]["end"])
        gaps = [a["end"].elapsed_time(b["start"])
                for a, b in zip(timed, timed[1:])]
        ds = opt["datasets"]["train"]
        res = dict(
            dtype=dtype, batch=ds["batch_size"], crop=ds["GT_size"],
            dcn_max_offset=r, steps=len(steps),
            launches=launches, launches_per_step=steps[-1]["launches"],
            losses=[{k: v.item() for k, v in st["logs"].items()}
                    for st in steps],
            steps_per_s=len(timed) / (ms / 1e3),
            step_ms=[st["start"].elapsed_time(st["end"]) for st in steps],
            gap_ms=gaps, idle_share=sum(gaps) / ms,
            peak_mem_gib=peak, params_moved=moved, profiled=profile)
        emit(phase="training", **res)
        if profile:
            with open(os.path.join(opt["path"]["experiments_root"], "profile",
                                   "summary.txt")) as f:
                print(f"--- torch.profiler, training {dtype}\n{f.read()}")
        results[dtype] = res
        del trainer, before, steps
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = False
    return results


def reduced_train_step():
    """One full-width Split step at 64x64, batch 2, f32: the card against
    the CPU from the same weights and batch.  The card runs the kernels in
    TF32 through ~45 layers and back: loss to 1e-3 relative, each gradient
    to 5e-2 of its largest magnitude."""
    import numpy as np
    import torch
    import yaml

    from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset
    from realvsr_tpu_torch.models.edvr import EDVRNoUp
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    with open(os.path.join(ROOT, RECIPE)) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")
    cfg = dict(nf=64, nc=3, nframes=3, groups=8, front_RBs=5, back_RBs=10,
               w_TSA=False, dcn_max_offset=train_r())
    cpu = EDVRNoUp(**cfg, device="cpu",
                   generator=torch.Generator().manual_seed(12))
    randomise_offset_convs(cpu, seed=13, std=0.5)
    ds = SyntheticVSRDataset(dict(N_frames=3, GT_size=64))
    items = [ds.get(i, np.random.default_rng(i)) for i in (3, 17)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        model = EDVRNoUp(**cfg, device=dev)
        model.load_state_dict(cpu.state_dict())
        state = create_train_state(model, opt)
        _, logs = make_split_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[dev] = logs["l_pix"].item()
        grads[dev] = {k: p.grad.float().cpu()
                      for k, p in model.named_parameters()}
    loss_rel = abs(losses["cuda"] / losses["cpu"] - 1)
    worst = max((((grads["cuda"][k] - g).abs().max()
                  / g.abs().max().clamp_min(1e-30)).item(), k)
                for k, g in grads["cpu"].items())
    emit(phase="reduced_train_step_card_vs_cpu", shape=[2, 3, 64, 64, 3],
         losses=losses, loss_rel_err=loss_rel, loss_tol=1e-3,
         worst_grad_rel_err=worst[0], worst_grad=worst[1], grad_tol=5e-2)
    if not (loss_rel <= 1e-3 and worst[0] <= 5e-2):
        raise AssertionError(f"card vs CPU step: loss {loss_rel}, "
                             f"{worst[1]} {worst[0]}")


def time_dcn_bwd():
    """dcn_bwd at the L1 / cascade shape of a batch-32 step, bf16, ±8.
    The plain version runs over the batch in chunks of 24 frames (autograd
    of the whole batch at once would not fit in device memory)."""
    import torch

    from realvsr_tpu_torch.ops.kernels.dcn import dcn_bwd, dcn_bwd_plain

    r = train_r()
    x, off, mask, wgt, gout = dcn_bwd_inputs(TRAIN_L1, torch.bfloat16, 4)
    outs = dcn_bwd(x, off, mask, wgt, gout, 8, r)
    p = x.shape[0] * x.shape[1] * x.shape[2]
    # what the function needs, once: tensor cores dS = g W^T and dW = g^T S,
    # 2 * p * 576 * 64 each; f32 cores one sampling per (pixel, tap,
    # channel) with its four corners' gradients, ~20 ops (the kernel's
    # second sampling for dW is its own cost, not the function's)
    b_ms, b_by = bound(nbytes(x, off, mask, wgt, gout, *outs),
                       4 * p * 576 * 64, 20 * p * 576, "bfloat16")
    del outs

    def plain():
        for i in range(0, x.shape[0], 24):
            dcn_bwd_plain(x[i:i + 24], off[i:i + 24], mask[i:i + 24], wgt,
                          gout[i:i + 24], 8, r)

    row = dict(ms=cuda_ms(lambda: dcn_bwd(x, off, mask, wgt, gout, 8, r),
                          5),
               plain_ms=cuda_ms(plain, 1, warmup=1),
               bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit(timing="dcn_bwd", case="L1 train", shape=TRAIN_L1, dtype="bfloat16",
         **row)
    return row


def time_kernels():
    import torch
    import torch.nn.functional as F

    from realvsr_tpu_torch.ops.deform_conv import apply_act
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_plain
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd, dcn_fwd_plain

    bf = torch.bfloat16
    rows = {}
    for name, shape, act in DCN_CASES:
        x, off, mask, wgt, bias = dcn_inputs(shape, bf, seed=1)
        out = dcn_fwd(x, off, mask, wgt, bias, 8, act=act, max_offset=4)
        p = x.shape[0] * x.shape[1] * x.shape[2]
        k = 9 * x.shape[3]
        # tensor cores: the tap GEMM; f32 cores: 4 corners x (mul + add)
        # + the mask, per sampled element
        b_ms, b_by = bound(nbytes(x, off, mask, wgt, bias, out),
                           2 * p * k * 64, 9 * p * k, "bfloat16")
        row = dict(
            ms=cuda_ms(lambda: dcn_fwd(x, off, mask, wgt, bias, 8, act=act,
                                       max_offset=4), 20),
            plain_ms=cuda_ms(lambda: dcn_fwd_plain(x, off, mask, wgt, bias, 8,
                                                   act, 4), 3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit(timing="dcn_fwd", case=name, shape=shape, dtype="bfloat16", **row)
        rows[("dcn_fwd", name)] = row
        del x, off, mask, out
    for name, shape, c2, act, residual in CONV_CASES:
        x, x2, wgt, bias, res = conv_inputs(shape, c2, residual, bf, 2)
        out = conv3x3(x, wgt, bias, act, res, x2)
        p = x.shape[0] * x.shape[1] * x.shape[2]
        b_ms, b_by = bound(nbytes(x, x2, wgt, bias, res, out),
                           2 * p * 9 * (x.shape[3] + (c2 or 0)) * 64, 0,
                           "bfloat16")
        xcat = x if x2 is None else torch.cat([x, x2], -1)
        x_nchw = xcat.permute(0, 3, 1, 2)  # channels_last memory, NCHW view
        w_cl = wgt.contiguous(memory_format=torch.channels_last)
        res_nchw = None if res is None else res.permute(0, 3, 1, 2)

        def library():  # cuDNN conv + separate bias / act / residual
            y = apply_act(F.conv2d(x_nchw, w_cl, bias, padding=1), act)
            return y if res_nchw is None else y + res_nchw

        row = dict(
            ms=cuda_ms(lambda: conv3x3(x, wgt, bias, act, res, x2), 20),
            plain_ms=cuda_ms(lambda: conv3x3_plain(x, wgt, bias, act, res, x2),
                             5),
            bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(library, 20))
        emit(timing="conv3x3", case=name, shape=shape, dtype="bfloat16", **row)
        rows[("conv3x3", name)] = row
        del x, x2, res, out
    return rows


def time_slice(model, lq_root):
    import torch

    from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt

    torch.cuda.reset_peak_memory_stats()
    res = evaluate_wo_gt(model, None, lq_root, n_frames=NFRAMES)
    window = torch.rand(1, NFRAMES, H, W, 3,
                        generator=torch.Generator().manual_seed(5)).cuda() \
        .to(torch.bfloat16)
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(window), 5)
    emit(timing="slice", resolution=f"{W}x{H}", nframes=NFRAMES,
         dtype="bfloat16", forward_ms=ms, forward_frames_per_s=1e3 / ms,
         evaluate_wo_gt_frames_per_s=res["frames_per_s"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return window


def profile(model, window):
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    with torch.inference_mode(), prof(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            model(window)
        torch.cuda.synchronize()
    print(p.key_averages().table(sort_by="cuda_time_total", row_limit=25))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from realvsr_tpu_torch.ops.kernels import _build

    t_start = time.time()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    card = smi()
    emit(phase="device", name=name, nvidia_smi=card,
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    logs = _build.build(["dcn_fwd", "conv3x3", "dcn_bwd"])
    for src, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {src}.cu\n{log.strip()}")
    emit(phase="build", seconds=time.time() - t0, built=sorted(logs))

    errs = check_kernels()
    bwd_errs = check_backward()
    with tempfile.TemporaryDirectory() as tmp:
        model, lq_root, launches = main_path(tmp)
        train = training_slice(tmp, "--profile" in sys.argv[1:])
        reduced_train_step()
        rows = time_kernels()
        rows["dcn_bwd"] = time_dcn_bwd()
        window = time_slice(model, lq_root)
        if "--profile" in sys.argv[1:]:
            profile(model, window)

    bf = torch.bfloat16
    # launches: the f32 training run (the recipe's precision), with each
    # path's counts beside it
    by_path = {name: {"inference": launches.get(name, 0),
                      **{f"training_{d}": train[d]["launches"][name]
                         for d in train}}
               for name in ("dcn_fwd", "conv3x3", "dcn_bwd")}
    bwd = bwd_errs[(bf, train_r(), False)]
    kernels = [
        dict(name="dcn_fwd", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_fwd.cu",
             replaces="realvsr_tpu/ops/pallas/dcn_frame_kernel.py:225",
             launches=by_path["dcn_fwd"]["training_float32"],
             launches_by_path=by_path["dcn_fwd"],
             max_abs_err=errs[("dcn_fwd", "L1", bf, 4)],
             **rows[("dcn_fwd", "L1")]),
        dict(name="conv3x3", route="cuda",
             source="realvsr_tpu_torch/csrc/conv3x3.cu",
             replaces="realvsr_tpu/ops/pallas/conv3x3_kernel.py:447",
             launches=by_path["conv3x3"]["training_float32"],
             launches_by_path=by_path["conv3x3"],
             max_abs_err=errs[("conv3x3", "front 64->64 relu", bf)],
             **rows[("conv3x3", "front 64->64 relu")]),
        dict(name="dcn_bwd", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_bwd.cu",
             replaces="realvsr_tpu/ops/pallas/dcn_frame_kernel.py:501",
             launches=by_path["dcn_bwd"]["training_float32"],
             launches_by_path=by_path["dcn_bwd"],
             max_abs_err=max(v["max_abs_err"] for v in bwd.values()),
             max_abs_err_by_output=bwd, **rows["dcn_bwd"]),
    ]
    emit(phase="done", seconds=time.time() - t_start)
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
