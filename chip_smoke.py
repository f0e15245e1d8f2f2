#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``realvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``realvsr_tpu_torch/csrc`` with nvcc, in
   parallel, print ``-Xptxas -v`` and one line per instantiation with its
   registers and spills (a spill in ``conv3x3.cu`` fails the run);
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes, in bf16 and f32, with the tolerances of
   ``realvsr_tpu_torch/ops/kernels/check.py``: the DCN forward and the
   64-out conv3x3 at the inference shapes; the conv3x3 at other widths
   (64->3 with and without bias, 64->216 lrelu, 64->256 with a residual at
   EDVR's upconv2 shape, 128 (64+64) -> 3 through two inputs), and one
   shape that routes to the ``mma.sync`` kernel (16+16 -> 64); the block DCN
   API at the L1 shape clamped to ±4 and ±8; the DCN backward at one
   training sample (3, 192, 192, 64) clamped to ±8 and exact, with offsets
   of a few pixels (taps outside the image) and with zero offsets, each of
   dx, doffset, dmask and dW on its own; and the conv3x3 autograd (64-out
   with and without an activation, and 64->3) against autograd of its
   plain version;
4. inference, each path through ``evaluate_wo_gt`` on a seeded synthetic
   PNG clip, bf16, seeded random weights with randomised DCN offset convs,
   DCN offsets clamped to ±4 (the JAX package's deployment setting), with
   the kernels' launch counts set to 0 before the path and read after it
   and held to the counts per window the model's routing gives; then the
   same weights at a reduced size on the card (f32 and bf16) against the
   CPU in f32:
   - EDVR_NoUp at full width (nf 64, 3 frames, 8 deformable groups, 5 + 10
     ResBlocks, no TSA) on a 5-frame 1024x512 clip;
   - TDAN as ``configs/train/train_TDAN_RealVSR_YCbCr_Split.yml`` gives it
     (nf 64, 3 frames, 8 groups, 5 + 10 ResBlocks, scale 1) on the same
     clip;
   - EDVR x4 with TSA as ``configs/train/train_EDVRx4_TSA_Vimeo90K.yml``
     gives it (7 frames, 5 + 10 ResBlocks) on a 7-frame clip at the
     Vimeo90K LR size 448x256 (output 1792x1024);
   - the block DCN API at the L1 shape (3, 512, 1024, 64), ±4;
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
   paths' shapes (every conv3x3 case in bf16 and in f32; the f32 yardstick
   is cuDNN with TF32 allowed, as the kernel runs), and each inference
   path's forward ms, frames/s and peak memory.

Prints one JSON line per check and timing, then the card line, the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
``--profile`` adds a ``torch.profiler`` breakdown of one window's forward
of each inference model.
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
TDAN_CFG = os.path.join("configs", "train",
                        "train_TDAN_RealVSR_YCbCr_Split.yml")
EDVRX4_CFG = os.path.join("configs", "train",
                          "train_EDVRx4_TSA_Vimeo90K.yml")
VIMEO_H, VIMEO_W = 256, 448      # the Vimeo90K LR frame
R_INFER = 4                      # the deployment DCN clamp
TRAIN_STEPS, TRAIN_WARMUP = 10, 2
TRAIN_BATCH = 32                 # the recipe's; f32 fits it too (PERF.md)


def emit(**kv):
    print(json.dumps(kv), flush=True)


def train_r() -> float:
    """The DCN clamp of the training command line (its default)."""
    from realvsr_tpu_torch.tools.train import DCN_MAX_OFFSET

    return DCN_MAX_OFFSET


def ptxas_lines(log: str) -> list:
    """(kernel, registers, spill stores, spill loads) per instantiation in
    an ``nvcc -Xptxas -v`` log."""
    rows, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill stores" in line and name:
            parts = line.split()
            spills = (int(parts[parts.index("spill") - 2]),
                      int(parts[parts.index("loads") - 3]))
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split()[0])
            rows.append((name, regs, *spills))
            name = None
    return rows


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


def counters() -> dict:
    """Every kernel wrapper, by its row name in the kernels line; each
    counts its own launches in ``.launches``."""
    from realvsr_tpu_torch.ops.deform_conv_block import (
        modulated_deform_conv_block)
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_fused
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_bwd, dcn_fwd

    return {"dcn_fwd": dcn_fwd, "conv3x3": conv3x3,
            "conv3x3_fused": conv3x3_fused, "dcn_bwd": dcn_bwd,
            "dcn_block": modulated_deform_conv_block}


def zero_counts() -> None:
    for f in counters().values():
        f.launches = 0


def read_counts() -> dict:
    return {k: f.launches for k, f in counters().items()}


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


def conv_inputs(shape, c2, residual, dtype, seed, cout=64, bias=True):
    """Seeded on the card (drawn in f32, then cast): a CPU draw of these
    sizes takes seconds."""
    import torch

    b, h, w, c1 = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*size):
        return torch.randn(*size, generator=g, device="cuda")

    x = randn(b, h, w, c1)
    x2 = randn(b, h, w, c2) if c2 else None
    wgt = (torch.rand(cout, c1 + c2, 3, 3, generator=g, device="cuda") * 2
           - 1) / (9 * (c1 + c2)) ** 0.5
    bs = randn(cout) * 0.1
    res = randn(b, h, w, cout) if residual else None
    return [None if t is None else t.to(dtype)
            for t in (x, x2, wgt, bs if bias else None, res)]


DCN_CASES = [  # (name, shape, act): the L1 / cascade and the L3 DCNs
    ("L1", (3, H, W, 64), None),
    ("L3", (3, H // 4, W // 4, 64), "lrelu"),
]
CONV_CASES = [  # (name, shape, c2, act, residual)
    ("front 64->64 relu", (3, H, W, 64), 0, "relu", False),
    ("front 64->64 +res", (3, H, W, 64), 0, None, True),
    ("PCD L1 128->64 lrelu", (3, H, W, 64), 64, "lrelu", False),
]
UPCONV2 = "EDVR upconv2 64->256 lrelu"
WIDE_CASES = [  # (name, shape, c2, cout, act, bias, residual)
    ("TDAN reconstruction 64->3", (3, H, W, 64), 0, 3, None, True, False),
    ("TDAN final_conv 64->3 no bias", (1, H, W, 64), 0, 3, None, False,
     False),
    ("64->216 lrelu", (3, H, W, 64), 0, 216, "lrelu", True, False),
    ("64->256 +res", (1, 2 * VIMEO_H, 2 * VIMEO_W, 64), 0, 256, None, True,
     True),
    (UPCONV2, (1, 2 * VIMEO_H, 2 * VIMEO_W, 64), 0, 256, "lrelu", True,
     False),
    ("128 (64+64)->3 two inputs", (3, H, W, 64), 64, 3, None, True, False),
]


def check_kernels():
    import torch

    from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
    from realvsr_tpu_torch.ops.deform_conv_block import (
        modulated_deform_conv_block)
    from realvsr_tpu_torch.ops.kernels.check import max_abs_err, tolerance
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_plain
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd, dcn_fwd_plain

    errs = {}

    def hold(key, out, ref, **info):
        err, tol = max_abs_err(out, ref), tolerance(ref)
        emit(check=key[0], dtype=str(out.dtype)[6:], max_abs_err=err,
             tol=tol, **info)
        if not (out.shape == ref.shape and err <= tol
                and torch.isfinite(out).all()):
            raise AssertionError(f"{key}: {err} > {tol}")
        errs[key] = err

    for dtype in (torch.bfloat16, torch.float32):
        for name, shape, act in DCN_CASES:
            for r in (None, 4):
                args = dcn_inputs(shape, dtype, seed=1)
                out = dcn_fwd(*args, 8, act=act, max_offset=r)
                torch.cuda.synchronize()
                ref = dcn_fwd_plain(*args, 8, act, r)
                hold(("dcn_fwd", name, dtype, r), out, ref, case=name,
                     shape=shape, act=act, max_offset=r)
                del out, ref, args
        for name, shape, c2, act, residual in CONV_CASES:
            x, x2, wgt, bias, res = conv_inputs(shape, c2, residual, dtype, 2)
            out = conv3x3(x, wgt, bias, act, res, x2)
            torch.cuda.synchronize()
            ref = conv3x3_plain(x, wgt, bias, act, res, x2)
            hold(("conv3x3", name, dtype), out, ref, case=name, shape=shape)
            del out, ref, x, x2, res
        for name, shape, c2, cout, act, bias, residual in WIDE_CASES:
            x, x2, wgt, bs, res = conv_inputs(shape, c2, residual, dtype, 3,
                                              cout, bias)
            out = conv3x3(x, wgt, bs, act, res, x2)
            torch.cuda.synchronize()
            ref = conv3x3_plain(x, wgt, bs, act, res, x2)
            hold(("conv3x3_fused", name, dtype), out, ref, case=name,
                 shape=shape, cout=cout, act=act, bias=bias,
                 residual=residual)
            del out, ref, x, x2, res
        # input widths that are not whole 128-byte chunks: the mma.sync
        # kernel (csrc/conv3x3_sync.cu), ragged tiles
        x, x2, wgt, bias, res = conv_inputs((2, 37, 45, 16), 16, True, dtype,
                                            4)
        out = conv3x3(x, wgt, bias, "relu", res, x2)
        torch.cuda.synchronize()
        ref = conv3x3_plain(x, wgt, bias, "relu", res, x2)
        hold(("conv3x3_sync", dtype), out, ref, case="16+16->64 relu +res",
             shape=(2, 37, 45, 16), route="mma.sync")
        for r in (4, 8):
            x, off, mask, wgt, bias = dcn_inputs(DCN_CASES[0][1], dtype, 1)
            out = modulated_deform_conv_block(x, off, mask, wgt, bias,
                                              deformable_groups=8,
                                              max_offset=r)
            torch.cuda.synchronize()
            ref = modulated_deform_conv_plain(x, off, mask, wgt, bias, 1, 1,
                                              1, 8, r)
            hold(("dcn_block", dtype, r), out, ref, case="L1",
                 shape=DCN_CASES[0][1], max_offset=r)
            del out, ref, x, off, mask
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
        for case, c2, act, residual, cout, has_bias in (
                ("64->64 +res", 0, None, True, 64, True),
                ("128->64 two inputs", 64, None, False, 64, True),
                ("64->64 relu", 0, "relu", False, 64, True),
                ("128->64 lrelu two inputs", 64, "lrelu", False, 64, True),
                ("64->3 no bias", 0, None, False, 3, False)):
            x, x2, wgt, bias, res = conv_inputs((3, 192, 192, 64), c2,
                                                residual, dtype, 7, cout,
                                                has_bias)
            named = [(n, t) for n, t in zip(
                ("dx", "dweight", "dbias", "dresidual", "dx2"),
                (x, wgt, bias, res, x2)) if t is not None]
            names = [n for n, _ in named]
            leaves = [t.requires_grad_() for _, t in named]
            cot = torch.randn(3, 192, 192, cout, generator=g).to("cuda",
                                                                 dtype)
            out = conv3x3_autograd(x, wgt, bias, act, res, x2)
            ours = torch.autograd.grad(out, leaves, cot)
            ref = conv3x3_plain_grads(out, cot, leaves, x, wgt, bias, act,
                                      res, x2)
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


def write_clip(root: str, seed: int, frames: int = CLIP, h: int = H,
               w: int = W) -> str:
    """A seeded clip of ``frames`` h x w PNGs of smooth texture moving 3
    px/frame; returns its root (one sequence, ``000``)."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.random((h // 8, w // 8 + 8, 3)).astype(np.float32),
                      (w + 64, h), interpolation=cv2.INTER_CUBIC)
    lq = os.path.join(root, f"LQ_{w}x{h}_{frames}", "000")
    os.makedirs(lq)
    for t in range(frames):
        frame = np.clip(base[:, 3 * t:3 * t + w] * 255, 0, 255)
        cv2.imwrite(os.path.join(lq, f"{t:05d}.png"), frame.astype(np.uint8))
    return os.path.dirname(lq)


def read_window(lq_root: str, n: int):
    """The clip's first ``n`` frames as one (1, n, H, W, 3) window on the
    card, RGB in [0, 1]."""
    import cv2
    import numpy as np
    import torch

    return torch.from_numpy(np.stack([
        cv2.imread(os.path.join(lq_root, "000", f"{t:05d}.png"))[..., ::-1]
        .astype(np.float32) / 255 for t in range(n)]))[None].cuda()


# Per window of each inference path, from the models' routing: 64-out
# conv3x3 = ResBlock convs + PCD offset convs (10) + HRconv, with EDVR's
# fea_L2_conv2, fea_L3_conv2, L2_fea_conv and L1_fea_conv (4), TDAN's
# bottle_neck and 4 offset convs and TSA's 6 3x3 convs; conv3x3 at other
# widths = the 4 DCNs' conv_offset_mask (64->216) and conv_last, with
# TDAN's reconstruction and final_conv and EDVR's upconv1 and upconv2.
EXPECT = {
    "edvr_noup": {"dcn_fwd": 4, "conv3x3": 41 + 4, "conv3x3_fused": 4 + 1},
    "tdan": {"dcn_fwd": 4, "conv3x3": 10 + 1 + 4 + 20,
             "conv3x3_fused": 4 + 2},
    "edvr_x4": {"dcn_fwd": 4, "conv3x3": 41 + 4 + 6,
                "conv3x3_fused": 4 + 3},
}


def drive_path(name, model, lq_root, n_frames, clip, out_hw, tmp):
    """One inference path through ``evaluate_wo_gt``: the counts set to 0
    just before it and read just after, held to ``EXPECT`` per window;
    every output saved at ``out_hw``; then one window's output checked
    (finite, shape, the DCN offsets in play)."""
    import cv2
    import torch

    from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt

    out_dir = os.path.join(tmp, f"out_{name}")
    zero_counts()
    res = evaluate_wo_gt(model, None, lq_root, n_frames=n_frames,
                         save_folder=out_dir)
    torch.cuda.synchronize()
    launches = read_counts()
    per_window = {k: v / clip for k, v in launches.items()}
    emit(phase="path", path=name, windows=clip, launches=launches,
         launches_per_window=per_window,
         frames_per_s_first_run=res["frames_per_s"])
    expect = dict(EXPECT[name], dcn_bwd=0, dcn_block=0)
    if per_window != expect:
        raise AssertionError(f"{name}: launches per window {per_window}, "
                             f"expected {expect}")
    saved = sorted(os.listdir(os.path.join(out_dir, "000")))
    if len(saved) != clip:
        raise AssertionError(f"{name}: expected {clip} outputs, got {saved}")
    for f in saved:
        img = cv2.imread(os.path.join(out_dir, "000", f))
        if img is None or img.shape != (*out_hw, 3):
            raise AssertionError(f"{name}: bad output {f}")

    window = read_window(lq_root, n_frames).to(torch.bfloat16)
    offs = []
    hooks = [m.conv_offset_mask.register_forward_hook(
        lambda mod, inp, out: offs.append(out[..., :out.shape[-1] * 2 // 3]))
        for m in model.modules() if hasattr(m, "conv_offset_mask")]
    with torch.inference_mode():
        y = model(window)
    for h in hooks:
        h.remove()
    if y.shape != (1, *out_hw, 3) or not torch.isfinite(y).all():
        raise AssertionError(f"{name}: output not finite or misshapen")
    emit(phase="path_output", path=name, shape=list(y.shape),
         out_min=y.min().item(), out_max=y.max().item(),
         offset_abs_mean=[o.float().abs().mean().item() for o in offs],
         offset_abs_max=[o.float().abs().max().item() for o in offs])
    return launches


def card_vs_cpu(name, build, model, shape):
    """The same weights at a reduced size: the card (f32 and bf16) against
    the CPU in f32, relative to the output's largest magnitude (~1 for
    EDVR, whose output adds the centre frame; a few hundredths for TDAN at
    random weights).  f32: TF32 kernels through ~45 layers, 2e-2; bf16:
    8-bit mantissas through the same depth, 5e-2."""
    import torch

    sd = {k: v.float().cpu() for k, v in model.state_dict().items()}
    cpu = build("cpu")
    cpu.load_state_dict(sd)
    card32 = build("cuda")
    card32.load_state_dict(sd)
    x = torch.rand(*shape, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        ref = cpu.eval()(x)
        top = ref.abs().max().item()
        for dtype, m, rel in ((torch.float32, card32.eval(), 2e-2),
                              (torch.bfloat16, model.eval(), 5e-2)):
            out = m(x.cuda().to(dtype)).float().cpu()
            err, tol = (out - ref).abs().max().item(), rel * top
            emit(phase="reduced_card_vs_cpu", path=name, dtype=str(dtype)[6:],
                 shape=list(x.shape), max_abs_err=err, tol=tol,
                 ref_abs_max=top)
            if not (out.shape == ref.shape and err <= tol
                    and torch.isfinite(out).all()):
                raise AssertionError(f"{name} reduced {dtype}: {err} > {tol}")
    del cpu, card32


def network_opt(path):
    import yaml

    with open(os.path.join(ROOT, path)) as f:
        return yaml.safe_load(f)


def inference_paths(tmp):
    """The three inference paths (module docstring, phase 4); returns
    {name: (model, clip root, frames per window, input (h, w), launches)}."""
    import torch

    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    bf = torch.bfloat16
    clip = write_clip(tmp, seed=2)
    paths = {}

    cfg = dict(nf=64, nc=3, nframes=NFRAMES, groups=8, front_RBs=5,
               back_RBs=10, w_TSA=False, dcn_max_offset=R_INFER)
    model = EDVRNoUp(**cfg, device="cuda", dtype=bf,
                     generator=torch.Generator().manual_seed(0))
    randomise_offset_convs(model, seed=1)
    launches = drive_path("edvr_noup", model, clip, NFRAMES, CLIP, (H, W),
                          tmp)
    card_vs_cpu("edvr_noup", lambda dev: EDVRNoUp(**cfg, device=dev), model,
                (1, NFRAMES, 64, 128, 3))
    paths["edvr_noup"] = (model, clip, NFRAMES, (H, W), launches)

    # name, recipe, weight seed, std of the offset convs' random weights
    for name, recipe, seed, std in (("tdan", TDAN_CFG, 20, 0.5),
                                    ("edvr_x4", EDVRX4_CFG, 30, 1.0)):
        opt = network_opt(recipe)
        n, scale = opt["network_G"]["nframes"], opt["scale"]

        def build(dev, dtype=torch.float32, seed=seed, opt=opt):
            return define_g(opt, device=dev, dtype=dtype,
                            generator=torch.Generator().manual_seed(seed),
                            dcn_max_offset=R_INFER)

        model = build("cuda", bf)
        randomise_offset_convs(model, seed=seed + 1, std=std)
        if name == "tdan":   # the flagship's clip: same frames, same size
            lq, frames, hw, small = clip, CLIP, (H, W), (64, 128)
        else:                # a clip at the Vimeo90K LR size
            frames, hw, small = n, (VIMEO_H, VIMEO_W), (64, 64)
            lq = write_clip(tmp, seed + 2, frames, *hw)
        launches = drive_path(name, model, lq, n, frames,
                              (hw[0] * scale, hw[1] * scale), tmp)
        card_vs_cpu(name, build, model, (1, n, *small, 3))
        paths[name] = (model, lq, n, hw, launches)
    return paths


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

    from realvsr_tpu_torch.train.trainer import Trainer

    kernels = counters()
    per_step = {"dcn_fwd": 4, "dcn_bwd": 4, **EXPECT["edvr_noup"],
                "dcn_block": 0}
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
            if st["launches"] != per_step:
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


def block_path():
    """Kernel 5's path: the block DCN API at the L1 shape, ±4, with the
    counts set to 0 just before it and read just after."""
    import torch

    from realvsr_tpu_torch.ops.deform_conv_block import (
        modulated_deform_conv_block)

    x, off, mask, wgt, bias = dcn_inputs(DCN_CASES[0][1], torch.bfloat16, 5)
    zero_counts()
    out = modulated_deform_conv_block(x, off, mask, wgt, bias,
                                      deformable_groups=8,
                                      max_offset=R_INFER)
    torch.cuda.synchronize()
    launches = read_counts()
    emit(phase="path", path="block_api", shape=DCN_CASES[0][1],
         max_offset=R_INFER, launches=launches)
    expect = dict(dcn_fwd=0, conv3x3=0, conv3x3_fused=0, dcn_bwd=0,
                  dcn_block=1)
    if launches != expect or not torch.isfinite(out).all():
        raise AssertionError(f"block API path: launches {launches}")
    return launches


def time_kernels():
    import torch
    import torch.nn.functional as F

    from realvsr_tpu_torch.ops.deform_conv import (apply_act,
                                                   modulated_deform_conv_plain)
    from realvsr_tpu_torch.ops.deform_conv_block import (
        modulated_deform_conv_block)
    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_plain
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd, dcn_fwd_plain

    bf = torch.bfloat16
    rows = {}

    def dcn_bound(x, off, mask, wgt, bias, out):
        # tensor cores: the tap GEMM; f32 cores: 4 corners x (mul + add)
        # + the mask, per sampled element
        p = x.shape[0] * x.shape[1] * x.shape[2]
        k = 9 * x.shape[3]
        return bound(nbytes(x, off, mask, wgt, bias, out), 2 * p * k * 64,
                     9 * p * k, "bfloat16")

    for name, shape, act in DCN_CASES:
        x, off, mask, wgt, bias = dcn_inputs(shape, bf, seed=1)
        out = dcn_fwd(x, off, mask, wgt, bias, 8, act=act, max_offset=4)
        b_ms, b_by = dcn_bound(x, off, mask, wgt, bias, out)
        row = dict(
            ms=cuda_ms(lambda: dcn_fwd(x, off, mask, wgt, bias, 8, act=act,
                                       max_offset=4), 20),
            plain_ms=cuda_ms(lambda: dcn_fwd_plain(x, off, mask, wgt, bias, 8,
                                                   act, 4), 3, warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit(timing="dcn_fwd", case=name, shape=shape, dtype="bfloat16", **row)
        rows[("dcn_fwd", name)] = row
        del x, off, mask, out
    # the block API at L1, ±4: kernel 1's code behind kernel 5's function
    x, off, mask, wgt, bias = dcn_inputs(DCN_CASES[0][1], bf, seed=1)

    def block():
        return modulated_deform_conv_block(x, off, mask, wgt, bias,
                                           deformable_groups=8,
                                           max_offset=R_INFER)

    b_ms, b_by = dcn_bound(x, off, mask, wgt, bias, block())
    row = dict(
        ms=cuda_ms(block, 20),
        plain_ms=cuda_ms(lambda: modulated_deform_conv_plain(
            x, off, mask, wgt, bias, 1, 1, 1, 8, R_INFER), 3, warmup=1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    emit(timing="dcn_block", case="L1", shape=DCN_CASES[0][1],
         max_offset=R_INFER, dtype="bfloat16", **row)
    rows["dcn_block"] = row
    del x, off, mask

    timed = [(name, shape, c2, 64, act, True, residual)
             for name, shape, c2, act, residual in CONV_CASES]
    timed += WIDE_CASES
    for dtype in (bf, torch.float32):
        dname = str(dtype)[6:]
        for name, shape, c2, cout, act, has_bias, residual in timed:
            x, x2, wgt, bias, res = conv_inputs(shape, c2, residual, dtype, 2,
                                                cout, has_bias)
            out = conv3x3(x, wgt, bias, act, res, x2)
            p = x.shape[0] * x.shape[1] * x.shape[2]
            b_ms, b_by = bound(nbytes(x, x2, wgt, bias, res, out),
                               2 * p * 9 * (x.shape[3] + (c2 or 0)) * cout, 0,
                               dname)
            xcat = x if x2 is None else torch.cat([x, x2], -1)
            x_nchw = xcat.permute(0, 3, 1, 2)  # channels_last, NCHW view
            w_cl = wgt.contiguous(memory_format=torch.channels_last)
            res_nchw = None if res is None else res.permute(0, 3, 1, 2)

            def library():  # cuDNN conv + separate bias / act / residual
                y = apply_act(F.conv2d(x_nchw, w_cl, bias, padding=1), act)
                return y if res_nchw is None else y + res_nchw

            # the f32 yardstick runs cuDNN in TF32, as the kernel runs
            torch.backends.cudnn.allow_tf32 = dtype == torch.float32
            library_ms = cuda_ms(library, 20)
            torch.backends.cudnn.allow_tf32 = False
            row = dict(
                ms=cuda_ms(lambda: conv3x3(x, wgt, bias, act, res, x2), 20),
                plain_ms=cuda_ms(
                    lambda: conv3x3_plain(x, wgt, bias, act, res, x2), 5),
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
            kernel = "conv3x3" if cout == 64 else "conv3x3_fused"
            emit(timing=kernel, case=name, shape=shape, cout=cout,
                 dtype=dname, **row)
            rows[(kernel, name, dname)] = row
            del x, x2, res, out
    return rows


def time_path(name, model, lq_root, n_frames, hw):
    """One path's restore through ``evaluate_wo_gt`` (host clock, upload and
    download included) and its forward alone (CUDA events over 5 windows
    of seeded noise after warm-up), bf16; peak memory over both."""
    import torch

    from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt

    torch.cuda.reset_peak_memory_stats()
    res = evaluate_wo_gt(model, None, lq_root, n_frames=n_frames)
    window = torch.rand(1, n_frames, *hw, 3,
                        generator=torch.Generator().manual_seed(5)).cuda() \
        .to(torch.bfloat16)
    with torch.inference_mode():
        ms = cuda_ms(lambda: model(window), 5)
    emit(timing="slice", path=name, resolution=f"{hw[1]}x{hw[0]}",
         nframes=n_frames, dtype="bfloat16", forward_ms=ms,
         forward_frames_per_s=1e3 / ms,
         evaluate_wo_gt_frames_per_s=res["frames_per_s"],
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    return window


def profile(name, model, window):
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    with torch.inference_mode(), prof(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(2):
            model(window)
        torch.cuda.synchronize()
    print(f"--- torch.profiler, {name}, 2 forwards")
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
    logs = _build.build(["dcn_fwd", "conv3x3", "conv3x3_sync", "dcn_bwd"])
    for src, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {src}.cu\n{log.strip()}")
    emit(phase="build", seconds=time.time() - t0, built=sorted(logs))
    for src, log in logs.items():
        for kernel, regs, stores, loads in ptxas_lines(log):
            emit(ptxas=src, kernel=kernel, registers=regs,
                 spill_stores=stores, spill_loads=loads)
            if src == "conv3x3" and (stores or loads):
                raise AssertionError(f"{kernel} spills")

    profiling = "--profile" in sys.argv[1:]
    errs = check_kernels()
    bwd_errs = check_backward()
    with tempfile.TemporaryDirectory() as tmp:
        paths = inference_paths(tmp)
        launches = {p: v[-1] for p, v in paths.items()}
        launches["block_api"] = block_path()
        train = training_slice(tmp, profiling)
        for d in train:
            launches[f"training_{d}"] = train[d]["launches"]
        reduced_train_step()
        rows = time_kernels()
        rows["dcn_bwd"] = time_dcn_bwd()
        for p, (model, lq_root, n, hw, _) in paths.items():
            window = time_path(p, model, lq_root, n, hw)
            if profiling:
                profile(p, model, window)

    bf = torch.bfloat16
    # each kernel's launches on every path; ``launches`` is the one of the
    # path that first put it on a model path (the f32 training run for the
    # flagship's kernels, the recipe's precision)
    by_path = {k: {p: c[k] for p, c in launches.items()} for k in counters()}
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
             **rows[("conv3x3", "front 64->64 relu", "bfloat16")]),
        dict(name="conv3x3_fused", route="cuda",
             source="realvsr_tpu_torch/csrc/conv3x3.cu",
             replaces="realvsr_tpu/ops/pallas/conv3x3_kernel.py:125",
             launches=by_path["conv3x3_fused"]["tdan"],
             launches_by_path=by_path["conv3x3_fused"],
             max_abs_err=errs[("conv3x3_fused", UPCONV2, bf)],
             **rows[("conv3x3_fused", UPCONV2, "bfloat16")]),
        dict(name="dcn_bwd", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_bwd.cu",
             replaces="realvsr_tpu/ops/pallas/dcn_frame_kernel.py:501",
             launches=by_path["dcn_bwd"]["training_float32"],
             launches_by_path=by_path["dcn_bwd"],
             max_abs_err=max(v["max_abs_err"] for v in bwd.values()),
             max_abs_err_by_output=bwd, **rows["dcn_bwd"]),
        dict(name="dcn_block", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_fwd.cu",
             wrapper="realvsr_tpu_torch/ops/deform_conv_block.py",
             replaces="realvsr_tpu/ops/pallas/dcn_block_kernel.py:82",
             launches=by_path["dcn_block"]["block_api"],
             launches_by_path=by_path["dcn_block"],
             max_abs_err=errs[("dcn_block", bf, R_INFER)],
             **rows["dcn_block"]),
    ]
    emit(phase="done", seconds=time.time() - t_start)
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
