#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``realvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``realvsr_tpu_torch/csrc`` with nvcc, in
   parallel, print ``-Xptxas -v`` and one line per instantiation with its
   registers and spills (a spill in ``conv3x3.cu``, ``dcn_fwd.cu`` or
   ``dcn_bwd.cu`` fails the run);
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes, in bf16 and f32, with the tolerances of
   ``realvsr_tpu_torch/ops/kernels/check.py``: the DCN forward at ±4, ±8
   and exact, with separate offsets and mask and with DCNPack's
   offset/mask tensor read in place (``om``), and the 64-out conv3x3 at
   the inference shapes; the conv3x3 at other widths
   (64->3 with and without bias, 64->216 lrelu, 64->256 with a residual at
   EDVR's upconv2 shape, 128 (64+64) -> 3 through two inputs), and one
   shape that routes to the ``mma.sync`` kernel (16+16 -> 64); the block DCN
   API at the L1 shape clamped to ±4 and ±8; the DCN backward, in both
   forms, at one training sample (3, 192, 192, 64) clamped to ±4, ±8 and
   exact, with offsets of a few pixels (taps outside the image) and with
   zero offsets, each gradient on its own; and the conv3x3 autograd (64-out
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
6. the evaluation slice:
   - both DCN kernels at 16 channels in 4 groups (``csrc/dcn_narrow.cu``,
     the repo's debug configs' width) at the debug config's L1 shape
     (12, 64, 64, 16), both forms, bf16 and f32, ±4, ±8 and exact,
     against their plain versions; then
     ``configs/train/debug_EDVR_woTSA_Split_synthetic.yml`` through the
     port's Trainer as the training command line runs it (16 iterations,
     validation and checkpoints at 8 and 16) with exact launch counts per
     step, and one of its steps at 64x64 on the card against the CPU;
   - streaming (``eval/streaming.py``) at full width with the inference
     phase's weights: the flagship's 5-frame 1024x512 clip (run, run_lazy,
     run_scan, run_scan_clips) and EDVR x4 + TSA's 7-frame 448x256 clip
     against the sliding window, with launches held to one pyramid per new
     frame and one fuse per output frame;
   - tiled 1080p (``eval/tiled.py``): the flagship at 1920x1088 in
     576x1024 tiles, overlap 32, batched against the tile loop and both
     against the full frame beyond the receptive field of every inner
     tile edge; ``--flip_test`` at 1024x512 against the four flipped
     forwards;
   - LPIPS / DISTS (seeded random VGG16) and NIQE / BRISQUE on the card
     against the CPU;
7. the training families, TDAN and EDVR x4 + TSA (DCN clamp ±8):
   - ``dcn_bwd`` against its plain version at the EDVR x4 + TSA recipe's
     DCN planes (224, 64|32|16, 64|32|16, 64), both forms, bf16 and f32,
     the 16- and 32-wide ones narrower than the backward's tile;
   - one Split step of each at full width and cut depth (TDAN nf 64, 1 + 1
     ResBlocks, LQ 64x64; EDVR x4 + TSA nf 64, 8 groups, 1 + 1 ResBlocks,
     5 frames, LQ 32x32), batch 2 of motion-synthetic frames, f32, the
     card against the CPU as the flagship's, EDVR x4's with
     ``ft_tsa_only`` (every non-TSA parameter bit-unchanged after the
     update, the TSA ones as the CPU's);
   - ``configs/train/smoke_TDAN_motion.yml`` and
     ``smoke_EDVRx4_motion.yml`` through the port's Trainer as the
     training command line runs them (bf16, their batch and crops),
     ``niter`` cut to 12 with validation (x4 for EDVR) and a checkpoint at
     the end, launches per step held to the models' routing;
   - the published recipes' networks and batches
     (``train_TDAN_RealVSR_YCbCr_Split.yml``, 192² x 32, 3 frames;
     ``train_EDVRx4_TSA_Vimeo90K.yml``, GT 256² x 32, 7 frames, without
     its cutblur, which cannot run at x4) on motion-synthetic data, 6
     steps each in f32 and bf16: steps/s, ms a step, idle share, peak
     memory;
8. times: each kernel, its plain version and the one PyTorch call that
   computes the same function (where there is one) with CUDA events at the
   paths' shapes (every conv3x3 case and both DCN kernels in bf16 and in
   f32, the DCN kernels in both forms; the f32 yardstick is cuDNN with TF32
   allowed, as the kernel runs), one ``DCNPack`` at L1 (its 64->216 conv
   and the DCN, glue included) beside the same module through the old
   chunk / cat / sigmoid glue and the separate-form kernel, and each
   inference path's forward ms, frames/s and peak memory; the narrow DCN
   kernels beside their plain versions; streaming run_scan frames/s on a
   12-frame 1024x512 clip and on two, beside one window's forward and its
   pyramid and fuse halves; tiled 1080p beside the full frame; the flip
   test; LPIPS, DISTS, NIQE and BRISQUE ms per 1024x512 frame; peak
   memory of each.

Prints one JSON line per check and timing, then the card line, the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
``--profile`` adds a ``torch.profiler`` breakdown of one window's forward
of each inference model and of the last two steps of each timed training
run (the flagship's and the two recipes').
"""
from __future__ import annotations

import json
import math
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


def om_of(off, mask):
    """DCNPack's offset/mask tensor for these offsets and mask: the offsets,
    then the mask's logits (the kernels take their sigmoid)."""
    import torch

    return torch.cat([off, torch.logit(mask.float(), eps=1e-3)
                      .to(off.dtype)], -1).contiguous()


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
    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_fwd, dcn_fwd_om,
                                                   dcn_fwd_om_plain,
                                                   dcn_fwd_plain)

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
            for r in (None, 4, 8):
                args = dcn_inputs(shape, dtype, seed=1)
                out = dcn_fwd(*args, 8, act=act, max_offset=r)
                torch.cuda.synchronize()
                ref = dcn_fwd_plain(*args, 8, act, r)
                hold(("dcn_fwd", name, dtype, r), out, ref, case=name,
                     shape=shape, act=act, max_offset=r, form="separate")
                del out, ref
                om = om_of(args[1], args[2])
                x, _, _, wgt, bias = args
                out = dcn_fwd_om(x, om, wgt, bias, 8, act=act, max_offset=r)
                torch.cuda.synchronize()
                ref = dcn_fwd_om_plain(x, om, wgt, bias, 8, act, r)
                hold(("dcn_fwd_om", name, dtype, r), out, ref, case=name,
                     shape=shape, act=act, max_offset=r, form="om")
                del out, ref, args, om, x
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


def dcn_bwd_inputs(shape, dtype, seed, zero_offsets=False, on_card=False):
    """x, offset, mask, weight, cotangent; offsets of std 2.5 px (taps
    outside the image at every border, some beyond ±8) or all zero (every
    position on the grid, as at the start of training).  ``on_card`` draws
    them on the card (a CPU draw at the training shape takes seconds)."""
    import torch

    b, h, w, c = shape
    dev = "cuda" if on_card else "cpu"
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g, device=dev)
    off = (torch.zeros(b, h, w, 8 * 18, device=dev) if zero_offsets
           else torch.randn(b, h, w, 8 * 18, generator=g, device=dev) * 2.5)
    mask = torch.rand(b, h, w, 8 * 9, generator=g, device=dev)
    wgt = (torch.rand(64, c, 3, 3, generator=g, device=dev) * 2 - 1) / (
        9 * c) ** 0.5
    gout = torch.randn(b, h, w, 64, generator=g, device=dev)
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
    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_om,
                                                   dcn_bwd_om_plain,
                                                   dcn_bwd_plain)

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for r in (R_INFER, train_r(), None):
            for zero in (False, True):
                x, off, mask, wgt, gout = dcn_bwd_inputs(BWD_SHAPE, dtype, 3,
                                                         zero)
                om = om_of(off, mask)
                for form, names, kernel, plain, args in (
                        ("separate", ("dx", "doffset", "dmask", "dweight"),
                         dcn_bwd, dcn_bwd_plain, (x, off, mask, wgt, gout)),
                        ("om", ("dx", "dom", "dweight"), dcn_bwd_om,
                         dcn_bwd_om_plain, (x, om, wgt, gout))):
                    out = kernel(*args, 8, r)
                    torch.cuda.synchronize()
                    ref = plain(*args, 8, r)
                    row = {}
                    for name, o, rf in zip(names, out, ref):
                        err, tol = max_abs_err(o, rf), grad_tolerance(rf)
                        row[name] = dict(max_abs_err=err, tol=tol)
                        if not (o.dtype == rf.dtype and o.shape == rf.shape
                                and err <= tol and torch.isfinite(o).all()):
                            raise AssertionError(
                                f"dcn_bwd {form} {name} {dtype} r={r} "
                                f"zero={zero}: {err} > {tol}")
                    emit(check="dcn_bwd", form=form, shape=BWD_SHAPE,
                         dtype=str(dtype)[6:], max_offset=r,
                         zero_offsets=zero, **row)
                    errs[(form, dtype, r, zero)] = row
                    del out, ref
                del x, off, mask, om, gout
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


def _train_opt(tmp, dtype, recipe=RECIPE, mode="Synthetic",
               steps=TRAIN_STEPS):
    """A training recipe as parsed, on a synthetic train set (``mode``) at
    its crop, batch and frames: no validation, no checkpoints, ``steps``
    iterations, f32 or ``mixed_precision``."""
    from realvsr_tpu_torch.core.config import parse

    opt = parse(os.path.join(ROOT, recipe), is_train=True,
                root=os.path.join(tmp, f"{os.path.basename(recipe)}_{dtype}"))
    train = opt["datasets"]["train"]
    opt["datasets"] = {"train": dict(
        name=f"{mode}_Train", mode=mode, phase="train",
        scale=opt["scale"] or 1, N_frames=train["N_frames"],
        GT_size=train["GT_size"], batch_size=train["batch_size"],
        n_workers=train["n_workers"], num_seqs=8, frames_per_seq=10,
        dataset_ratio=20)}
    if mode == "SyntheticMotion":   # frames a little larger than the crop
        side = train["GT_size"] + 32
        opt["datasets"]["train"].update(frame_h=side, frame_w=side)
    opt["train"].update(niter=steps, val_freq=None,
                        mixed_precision=dtype == "bfloat16")
    opt["logger"]["save_checkpoint_freq"] = 10 ** 9
    return opt


def warm_motion(opt) -> float:
    """Generate every motion-synthetic frame the train set of ``opt`` reads
    (the generator caches them in the process), in threads, before the
    run: data set-up, kept out of the timed steps.  Returns the seconds."""
    from concurrent.futures import ThreadPoolExecutor

    from realvsr_tpu_torch.data import synthetic

    ds = opt["datasets"]["train"]
    if ds["mode"] != "SyntheticMotion":
        return 0.0
    t0 = time.time()
    args = [(s, t, ds["frame_h"], ds["frame_w"], ds.get("scale") or 1)
            for s in range(ds["num_seqs"])
            for t in range(ds["frames_per_seq"])]
    with ThreadPoolExecutor(8) as pool:   # each LQ frame makes its GT
        for _ in pool.map(lambda a: synthetic._lq_frame(*a), args):
            pass
    return time.time() - t0


def run_trainer(opt, per_step, *, offsets_seed=None, warmup=TRAIN_WARMUP,
                profile=False):
    """``opt`` through the port's Trainer on the card, as the training
    command line runs it (DCN clamp ±8).  The counts are set to 0 just
    before the run and read just after; each step's launches are held to
    ``per_step``, its losses must be finite, every parameter must move and
    every validation be finite.  Steps after ``warmup`` are timed start to
    end (the host loader included); the gaps between one step's end and the
    next one's start on the device's clock are its idle time.  With
    ``offsets_seed`` the DCN offset convs are randomised first; with
    ``profile`` the last two steps are traced (and then the steps/s is not
    the one to report)."""
    import torch

    from realvsr_tpu_torch.train.trainer import Trainer

    trainer = Trainer(opt, device="cuda", dcn_max_offset=train_r())
    niter = int(opt["train"]["niter"])
    if profile:
        trainer.profile_steps = (niter - 2, niter)
    if offsets_seed is not None:
        randomise_offset_convs(trainer.model, seed=offsets_seed, std=0.5)
    before = {k: v.detach().clone()
              for k, v in trainer.model.named_parameters()}
    kernels, steps, vals = counters(), [], []
    inner, inner_val = trainer.train_step, trainer.validate

    def step(state, batch, gen):
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

    def validate(at):
        psnr = inner_val(at)
        vals.append((at, psnr))
        return psnr

    trainer.train_step, trainer.validate = step, validate
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    trainer.train()
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if len(steps) != niter:
        raise AssertionError(f"{len(steps)} steps run, {niter} asked")
    for i, st in enumerate(steps):
        if st["launches"] != per_step:
            raise AssertionError(f"step {i}: launches {st['launches']}, "
                                 f"expected {per_step}")
        if not all(torch.isfinite(v).item() for v in st["logs"].values()):
            raise AssertionError(f"step {i}: losses {st['logs']}")
    moved = sum(not torch.equal(before[k], v.detach())
                for k, v in trainer.model.named_parameters())
    if moved != len(before):
        raise AssertionError(f"{len(before) - moved} parameters did not "
                             "move")
    if not all(math.isfinite(p) for _, p in vals):
        raise AssertionError(f"validation {vals}")
    timed = steps[warmup:]
    ms = timed[0]["start"].elapsed_time(timed[-1]["end"])
    gaps = [a["end"].elapsed_time(b["start"])
            for a, b in zip(timed, timed[1:])]
    step_ms = [st["start"].elapsed_time(st["end"]) for st in steps]
    ds = opt["datasets"]["train"]
    res = dict(
        batch=ds["batch_size"], crop=ds["GT_size"], frames=ds["N_frames"],
        scale=ds.get("scale") or 1, dcn_max_offset=train_r(),
        steps=len(steps), launches=launches,
        launches_per_step=steps[-1]["launches"],
        losses=[{k: v.item() for k, v in st["logs"].items()} for st in steps],
        steps_per_s=len(timed) / (ms / 1e3), step_ms=step_ms,
        median_step_ms=sorted(step_ms[warmup:])[len(timed) // 2],
        gap_ms=gaps, idle_share=sum(gaps) / ms, peak_mem_gib=peak,
        params_moved=moved, validation_psnr=vals, profiled=profile,
        checkpoints=sorted(os.listdir(opt["path"]["models"])))
    if profile:
        with open(os.path.join(opt["path"]["experiments_root"], "profile",
                               "summary.txt")) as f:
            res["profile"] = f.read()
    del trainer, before, steps
    torch.cuda.empty_cache()
    return res


def training_slice(tmp, profile=False):
    """The flagship's Split recipe through the port's Trainer, f32 and
    bf16, offsets randomised.  With ``profile`` its last two steps are
    traced."""
    import torch

    per_step = {"dcn_fwd": 4, "dcn_bwd": 4, **EXPECT["edvr_noup"],
                "dcn_block": 0}
    results = {}
    # PyTorch's defaults, as the recipe runs: cuDNN convs in TF32, like the
    # kernels; the checks around this phase run cuDNN in full f32
    torch.backends.cudnn.allow_tf32 = True
    for dtype in ("float32", "bfloat16"):
        res = run_trainer(_train_opt(tmp, dtype), per_step, offsets_seed=11,
                          profile=profile)
        summary = res.pop("profile", None)
        emit(phase="training", dtype=dtype, **res)
        if summary:
            print(f"--- torch.profiler, training {dtype}\n{summary}")
        results[dtype] = res
    torch.backends.cudnn.allow_tf32 = False
    return results


def reduced_train_step(recipe=RECIPE, cuts=None, side=64, mode="Synthetic",
                       ft_tsa_only=0, spread=False):
    """One Split step of ``recipe``'s network (depth cut by ``cuts``) on a
    batch of 2 with LQ ``side`` x ``side`` from the ``mode`` train set, f32:
    the card against the CPU from the same weights (offset convs
    randomised) and batch.  The card runs the kernels in TF32 (the narrow
    DCN in f32) through the model and back: loss to 1e-3 relative, each
    gradient to 5e-2 of its largest magnitude.  With ``ft_tsa_only`` (2:
    the first update trains ``tsa_fusion`` alone) every other parameter
    must stay bit-unchanged on the card, and the ``tsa_fusion`` ones match
    the CPU's after the update within 2 LR (Adam's first update is LR * g /
    (|g| + eps): a small gradient's sign may differ) plus 1e-6 relative.
    With ``spread`` each gradient's bound adds the CPU's own change in it
    when the LQ input moves by TF32's rounding (2^-11 relative, seeded
    noise): how far operands rounded as the card's f32 kernels round them
    can move it.  TSA's spatial attention routes its gradients through
    3x3 max pools, whose choice such a change can flip.  Returns the card
    step's launches."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.data.synthetic import (SyntheticMotionVSRDataset,
                                                  SyntheticVSRDataset)
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    opt = network_opt(recipe)
    opt.pop("augment")
    opt["network_G"].update(cuts or {})
    opt["train"]["ft_tsa_only"] = ft_tsa_only
    scale, n = opt["scale"] or 1, opt["network_G"]["nframes"]
    r = train_r()
    cpu = define_g(opt, device="cpu", dcn_max_offset=r,
                   generator=torch.Generator().manual_seed(12))
    randomise_offset_convs(cpu, seed=13, std=0.5)
    if mode == "SyntheticMotion":
        ds = SyntheticMotionVSRDataset(dict(
            N_frames=n, GT_size=side * scale, scale=scale,
            frame_h=side * scale + 32, frame_w=side * scale + 32))
    else:
        ds = SyntheticVSRDataset(dict(N_frames=n, GT_size=side))
    items = [ds.get(i, np.random.default_rng(i)) for i in (3, 17)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}
    grads, losses, after = {}, {}, {}
    for dev in ("cpu", "cuda"):
        model = define_g(opt, device=dev, dcn_max_offset=r)
        model.load_state_dict(cpu.state_dict())
        state = create_train_state(model, opt)
        zero_counts()
        _, logs = make_split_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[dev] = logs["l_pix"].item()
        grads[dev] = {k: p.grad.float().cpu()
                      for k, p in model.named_parameters()}
        after[dev] = {k: p.detach().float().cpu()
                      for k, p in model.named_parameters()}
    launches = read_counts()
    cpu_spread = {k: 0.0 for k in grads["cpu"]}
    if spread:
        g = torch.Generator().manual_seed(16)
        lq = batch["LQs"]
        noisy = dict(batch, LQs=lq * (1 + 2.0 ** -11 * torch.randn(
            lq.shape, generator=g)))
        model = define_g(opt, device="cpu", dcn_max_offset=r)
        model.load_state_dict(cpu.state_dict())
        make_split_train_step(model, opt)(create_train_state(model, opt),
                                          noisy, torch.Generator())
        cpu_spread = {k: (p.grad - grads["cpu"][k]).abs().max().item()
                 for k, p in model.named_parameters()}
    loss_rel = abs(losses["cuda"] / losses["cpu"] - 1)
    # (error / bound, error relative to the tensor's largest, CPU spread
    # relative to it, name)
    errs = []
    for k, g in grads["cpu"].items():
        top = g.abs().max().clamp_min(1e-30).item()
        err = (grads["cuda"][k] - g).abs().max().item()
        errs.append((err / (5e-2 * top + cpu_spread[k]), err / top,
                     cpu_spread[k] / top, k))
    errs.sort()
    info = {}
    ok = loss_rel <= 1e-3 and errs[-1][0] <= 1.0
    if ft_tsa_only:
        lr = float(opt["train"]["lr_G"])
        init = cpu.state_dict()
        frozen = [k for k in after["cuda"] if "tsa_fusion" not in k]
        tsa = [k for k in after["cuda"] if "tsa_fusion" in k]
        unchanged = sum(torch.equal(after["cuda"][k], init[k])
                        for k in frozen)
        tsa_err = max((after["cuda"][k] - after["cpu"][k]).abs().max().item()
                      for k in tsa)
        tsa_moved = sum(not torch.equal(after["cuda"][k], init[k])
                        for k in tsa)
        tsa_tol = 2.0001 * lr + 1e-6 * max(
            after["cpu"][k].abs().max().item() for k in tsa)
        info = dict(ft_tsa_only=ft_tsa_only, frozen=len(frozen),
                    frozen_bit_unchanged=unchanged, tsa=len(tsa),
                    tsa_moved=tsa_moved, tsa_param_max_abs_err=tsa_err,
                    tsa_param_tol=tsa_tol)
        ok = ok and (unchanged == len(frozen) and tsa_moved == len(tsa)
                     and tsa_err <= tsa_tol)
    emit(phase="reduced_train_step_card_vs_cpu", config=recipe,
         network=opt["network_G"], shape=list(batch["LQs"].shape),
         gt_shape=list(batch["GT"].shape), data=mode, losses=losses,
         loss_rel_err=loss_rel, loss_tol=1e-3,
         worst_grad_rel_err=max(e[1] for e in errs),
         worst_grad=max(errs, key=lambda e: e[1])[3],
         worst_err_over_bound=errs[-1][0], worst_by_bound=errs[-3:],
         grad_tol=5e-2, cpu_spread=spread, card_launches=launches,
         **info)
    if not ok:
        raise AssertionError(f"card vs CPU step {recipe}: loss {loss_rel}, "
                             f"{errs[-1]}, {info}")
    return launches


def time_dcn_bwd():
    """dcn_bwd at the L1 / cascade shape of a batch-32 step, ±8, in both
    forms, bf16 and f32.  The plain version (bf16 only) runs over the batch
    in chunks of 24 frames (autograd of the whole batch at once would not
    fit in device memory)."""
    import torch

    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_om,
                                                   dcn_bwd_plain)

    r, rows = train_r(), {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        x, off, mask, wgt, gout = dcn_bwd_inputs(TRAIN_L1, dtype, 4,
                                                 on_card=True)
        om = om_of(off, mask)
        outs = dcn_bwd(x, off, mask, wgt, gout, 8, r)
        p = x.shape[0] * x.shape[1] * x.shape[2]
        # what the function needs, once (the om form moves the same
        # elements): tensor cores dS = g W^T and dW = g^T S, 2 * p * 576 *
        # 64 each; f32 cores one sampling per (pixel, tap, channel) with its
        # four corners' gradients, ~20 ops
        b_ms, b_by = bound(nbytes(x, off, mask, wgt, gout, *outs),
                           4 * p * 576 * 64, 20 * p * 576, dname)
        del outs

        def plain():
            for i in range(0, x.shape[0], 24):
                dcn_bwd_plain(x[i:i + 24], off[i:i + 24], mask[i:i + 24],
                              wgt, gout[i:i + 24], 8, r)

        row = dict(
            ms=cuda_ms(lambda: dcn_bwd(x, off, mask, wgt, gout, 8, r), 5),
            ms_om=cuda_ms(lambda: dcn_bwd_om(x, om, wgt, gout, 8, r), 5),
            plain_ms=(cuda_ms(plain, 1, warmup=1)
                      if dtype == torch.bfloat16 else None),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit(timing="dcn_bwd", case="L1 train", shape=TRAIN_L1, dtype=dname,
             max_offset=r, **row)
        rows[dname] = row
        del x, off, mask, om, gout
        torch.cuda.empty_cache()
    return rows


def time_dcnpack():
    """One DCNPack at the L1 shape, bf16, ±4, under inference: its 64->216
    offset/mask conv and the DCN reading that tensor in place, against the
    same module's weights through the chunk / cat / sigmoid glue and the
    separate-form kernel (what DCNPack ran before the in-place form)."""
    import torch

    from realvsr_tpu_torch.models.common import DCNPack, reset_parameters
    from realvsr_tpu_torch.ops.kernels.check import max_abs_err
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd

    bf = torch.bfloat16
    gen = torch.Generator().manual_seed(8)
    pack = DCNPack(64, 64, 8, R_INFER)
    reset_parameters(pack, gen)
    pack.reset_parameters(gen)
    randomise_offset_convs(pack, seed=9, std=0.1)  # offsets of ~2.4 px
    pack = pack.to("cuda", bf).eval()
    g = torch.Generator(device="cuda").manual_seed(10)
    x, feat = (torch.randn(*DCN_CASES[0][1], generator=g, device="cuda")
               .to(bf) for _ in range(2))
    wgt, bias = pack.weight, pack.bias

    def split():
        o1, o2, m = torch.chunk(pack.conv_offset_mask(feat), 3, dim=-1)
        return dcn_fwd(x, torch.cat([o1, o2], -1),
                       torch.sigmoid(m).contiguous(), wgt, bias, 8, None,
                       R_INFER)

    with torch.inference_mode():
        out = pack(x, feat)
        err = max_abs_err(out, split())
        p = x.shape[0] * x.shape[1] * x.shape[2]
        b_ms, b_by = bound(
            nbytes(x, feat, out, *pack.parameters()),
            2 * p * 576 * (216 + 64), 9 * p * 576, "bfloat16")
        row = dict(ms=cuda_ms(lambda: pack(x, feat), 20),
                   ms_split_glue=cuda_ms(split, 20), bound_ms=b_ms,
                   bound_by=b_by, om_vs_split_max_abs_err=err)
    emit(timing="dcnpack", case="L1", shape=DCN_CASES[0][1], dtype="bfloat16",
         max_offset=R_INFER, **row)
    if not torch.isfinite(out).all():
        raise AssertionError("DCNPack output not finite")
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
    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_fwd, dcn_fwd_om,
                                                   dcn_fwd_plain)

    bf = torch.bfloat16
    rows = {}

    def dcn_bound(x, off, mask, wgt, bias, out, dname="bfloat16"):
        # tensor cores: the tap GEMM; f32 cores: 4 corners x (mul + add)
        # + the mask, per sampled element
        p = x.shape[0] * x.shape[1] * x.shape[2]
        k = 9 * x.shape[3]
        return bound(nbytes(x, off, mask, wgt, bias, out), 2 * p * k * 64,
                     9 * p * k, dname)

    for dtype in (bf, torch.float32):
        dname = str(dtype)[6:]
        for name, shape, act in DCN_CASES:
            if dtype == torch.float32 and name != "L1":
                continue
            x, off, mask, wgt, bias = dcn_inputs(shape, dtype, seed=1)
            om = om_of(off, mask)
            out = dcn_fwd(x, off, mask, wgt, bias, 8, act=act, max_offset=4)
            b_ms, b_by = dcn_bound(x, off, mask, wgt, bias, out, dname)
            row = dict(
                ms=cuda_ms(lambda: dcn_fwd(x, off, mask, wgt, bias, 8,
                                           act=act, max_offset=4), 20),
                ms_om=cuda_ms(lambda: dcn_fwd_om(x, om, wgt, bias, 8,
                                                 act=act, max_offset=4), 20),
                plain_ms=(cuda_ms(lambda: dcn_fwd_plain(
                    x, off, mask, wgt, bias, 8, act, 4), 3, warmup=1)
                    if dtype == bf else None),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)
            emit(timing="dcn_fwd", case=name, shape=shape, dtype=dname,
                 **row)
            rows[("dcn_fwd", name, dname)] = row
            del x, off, mask, out, om
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


# --------------------------------------------------------------------------
# The evaluation slice: the narrow DCN, streaming, tiled 1080p, metrics.

DEBUG_CFG = os.path.join("configs", "train",
                         "debug_EDVR_woTSA_Split_synthetic.yml")
NARROW_SHAPE = (12, 64, 64, 16)  # the debug config's L1 / cascade DCN
# per training step of the debug config (nf 16, 1 + 1 ResBlocks), from the
# model's routing: the 64-out conv3x3 is HRconv (16 -> 64); the other widths
# are the ResBlocks' 4 convs, fea_L2_conv2 / fea_L3_conv2, PCD's 10 offset
# convs and L2_fea_conv / L1_fea_conv, the 4 conv_offset_mask (16 -> 108)
# and conv_last
DEBUG_STEP = {"dcn_fwd": 4, "dcn_bwd": 4, "conv3x3": 1, "conv3x3_fused": 23,
              "dcn_block": 0}
# the front end (mode="pyramid") of every EDVR path: the 5 front ResBlocks'
# 10 convs, fea_L2_conv2 and fea_L3_conv2; the rest of a window is "fuse"
PYRAMID = {"conv3x3": 12}
STREAM_REL = 1e-2   # streamed vs sliding window, of the output's max |.|
TILE_HW, TILE_OVERLAP, HD = (576, 1024), 32, (1088, 1920)
STREAM_FRAMES = 12  # the timed stream
METRIC_REL = 1e-3   # LPIPS / DISTS card vs CPU, both f32


def fuse_counts(path):
    """Launches of one ``mode="fuse"`` call of an inference path."""
    return {k: v - PYRAMID.get(k, 0) for k, v in EXPECT[path].items()}


def narrow_inputs(dtype, seed):
    """x, offset (std 2.5 px), mask, weight, bias, cotangent at the debug
    config's DCN shape, 16 channels in 4 groups, on the card."""
    import torch

    b, h, w, c = NARROW_SHAPE
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, h, w, c, generator=g)
    off = torch.randn(b, h, w, 4 * 18, generator=g) * 2.5
    mask = torch.rand(b, h, w, 4 * 9, generator=g)
    wgt = (torch.rand(c, c, 3, 3, generator=g) * 2 - 1) / (9 * c) ** 0.5
    bias = torch.randn(c, generator=g) * 0.1
    gout = torch.randn(b, h, w, c, generator=g)
    return [t.to("cuda", dtype) for t in (x, off, mask, wgt, bias, gout)]


def check_narrow():
    """Both DCN kernels at 16 channels in 4 groups (``csrc/dcn_narrow.cu``),
    both forms, bf16 and f32, ±4, ±8 and exact, against their plain
    versions with the tolerances of ``ops/kernels/check.py``.  Returns
    {(kernel, form, dtype, r): max abs err (largest over the outputs)}."""
    import torch

    from realvsr_tpu_torch.ops.kernels.check import (grad_tolerance,
                                                     max_abs_err, tolerance)
    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_om,
                                                   dcn_bwd_om_plain,
                                                   dcn_bwd_plain, dcn_fwd,
                                                   dcn_fwd_om,
                                                   dcn_fwd_om_plain,
                                                   dcn_fwd_plain)

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for r in (4, 8, None):
            x, off, mask, wgt, bias, gout = narrow_inputs(dtype, 21)
            om = om_of(off, mask)
            for form, fwd, fwd_ref, bwd, bwd_ref, names in (
                    ("separate",
                     lambda: dcn_fwd(x, off, mask, wgt, bias, 4, "lrelu", r),
                     lambda: dcn_fwd_plain(x, off, mask, wgt, bias, 4,
                                           "lrelu", r),
                     lambda: dcn_bwd(x, off, mask, wgt, gout, 4, r),
                     lambda: dcn_bwd_plain(x, off, mask, wgt, gout, 4, r),
                     ("dx", "doffset", "dmask", "dweight")),
                    ("om",
                     lambda: dcn_fwd_om(x, om, wgt, bias, 4, "lrelu", r),
                     lambda: dcn_fwd_om_plain(x, om, wgt, bias, 4, "lrelu",
                                              r),
                     lambda: dcn_bwd_om(x, om, wgt, gout, 4, r),
                     lambda: dcn_bwd_om_plain(x, om, wgt, gout, 4, r),
                     ("dx", "dom", "dweight"))):
                out, grads = fwd(), bwd()
                torch.cuda.synchronize()
                ref, grefs = fwd_ref(), bwd_ref()
                row = {"out": dict(max_abs_err=max_abs_err(out, ref),
                                   tol=tolerance(ref))}
                ok = (out.shape == ref.shape and torch.isfinite(out).all()
                      and row["out"]["max_abs_err"] <= row["out"]["tol"])
                for name, o, rf in zip(names, grads, grefs):
                    row[name] = dict(max_abs_err=max_abs_err(o, rf),
                                     tol=grad_tolerance(rf))
                    ok = ok and (o.shape == rf.shape and o.dtype == rf.dtype
                                 and torch.isfinite(o).all()
                                 and row[name]["max_abs_err"]
                                 <= row[name]["tol"])
                emit(check="dcn_narrow", form=form, shape=NARROW_SHAPE,
                     groups=4, dtype=str(dtype)[6:], max_offset=r, **row)
                if not ok:
                    raise AssertionError(f"dcn narrow {form} {dtype} r={r}: "
                                         f"{row}")
                dname = str(dtype)[6:]
                errs[("dcn_fwd", form, dname, r)] = row["out"]["max_abs_err"]
                errs[("dcn_bwd", form, dname, r)] = max(
                    row[n]["max_abs_err"] for n in names)
    return errs


def narrow_training(tmp):
    """``python -m realvsr_tpu_torch.tools.train -opt DEBUG_CFG --device
    cuda`` as the command line runs it (the config parsed as is: nf 16, 4
    groups, 16 iterations at 64x64 batch 4, validation and checkpoints at
    8 and 16, DCN clamp ±8), through :func:`run_trainer` with the offset
    convs randomised before the loop and the launches held to DEBUG_STEP;
    both validations at 8 and 16 and the checkpoints written."""
    from realvsr_tpu_torch.core.config import parse

    opt = parse(os.path.join(ROOT, DEBUG_CFG), is_train=True,
                root=os.path.join(tmp, "debug"))
    t0 = time.time()
    res = run_trainer(opt, DEBUG_STEP, offsets_seed=22)
    res["seconds"] = time.time() - t0
    emit(phase="training_debug_nf16", config=DEBUG_CFG, **res)
    if [a for a, _ in res["validation_psnr"]] != [8, 16]:
        raise AssertionError(f"validation {res['validation_psnr']}")
    if not {"8_G.pth", "16_G.pth", "latest_G.pth"} <= set(
            res["checkpoints"]):
        raise AssertionError(f"checkpoints {res['checkpoints']}")
    return res["launches"], res["launches_per_step"]


def time_narrow():
    """Both narrow DCN kernels at the debug shape, bf16 and f32, ±8 (the
    training clamp), separate form, beside their plain versions."""
    import torch

    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_plain,
                                                   dcn_fwd, dcn_fwd_plain)

    r, rows = train_r(), {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        x, off, mask, wgt, bias, gout = narrow_inputs(dtype, 23)
        out = dcn_fwd(x, off, mask, wgt, bias, 4, None, r)
        grads = dcn_bwd(x, off, mask, wgt, gout, 4, r)
        p = x.shape[0] * x.shape[1] * x.shape[2]
        k = 9 * x.shape[3]
        # forward: the tap products (2 p k 16, at the tensor cores' rate
        # for the dtype, the card's best for them, whatever the kernel
        # runs them on) and the sampling, ~9 f32 ops a sampled element;
        # backward: dS and dW (2 x 2 p k 16) and ~20 f32 ops a sampled
        # element with its corners' gradients
        fwd_bytes = nbytes(x, off, mask, wgt, bias, out)
        bwd_bytes = nbytes(x, off, mask, wgt, gout, *grads)
        for name, fn, plain, moved, tc_ops, f32_ops in (
                ("dcn_fwd", lambda: dcn_fwd(x, off, mask, wgt, bias, 4,
                                            None, r),
                 lambda: dcn_fwd_plain(x, off, mask, wgt, bias, 4, None, r),
                 fwd_bytes, 2 * p * k * 16, 9 * p * k),
                ("dcn_bwd", lambda: dcn_bwd(x, off, mask, wgt, gout, 4, r),
                 lambda: dcn_bwd_plain(x, off, mask, wgt, gout, 4, r),
                 bwd_bytes, 4 * p * k * 16, 20 * p * k)):
            b_ms, b_by = bound(moved, tc_ops, f32_ops, dname)
            row = dict(ms=cuda_ms(fn, 50), plain_ms=cuda_ms(plain, 5),
                       bound_ms=b_ms, bound_by=b_by, library_ms=None)
            emit(timing=name, case="narrow C16 dg4", shape=NARROW_SHAPE,
                 dtype=dname, max_offset=r, **row)
            rows[(name, dname)] = row
    return rows


# --------------------------------------------------------------------------
# The training families: TDAN and EDVR x4 + TSA.

TDAN_SMOKE = os.path.join("configs", "train", "smoke_TDAN_motion.yml")
EDVRX4_SMOKE = os.path.join("configs", "train", "smoke_EDVRx4_motion.yml")
SMOKE_ITERS = 12
RECIPE_STEPS = 6
# per training step, from the models' routing: the forward's launches of a
# window (EXPECT) and one dcn_bwd a DCN
FAMILY_STEP = {name: dict(EXPECT[name], dcn_bwd=4, dcn_block=0)
               for name in ("tdan", "edvr_x4")}
# the DCN planes of the EDVR x4 + TSA recipe, 7 frames x batch 32 at LQ
# 64x64: L1 and the cascade, L2, L3; the last two narrower than the
# backward's 32-pixel tile (ops/kernels/dcn.py: BWD_TW)
X4_BWD_SHAPES = [(224, 64, 64, 64), (224, 32, 32, 64), (224, 16, 16, 64)]
# card-vs-CPU steps: (recipe, depth cuts, LQ side, ft_tsa_only); the
# gradients do not depend on ft_tsa_only, only the update does
FAMILY_CASES = [
    (TDAN_CFG, dict(nb_f=1, nb_b=1), 64, 0),
    (EDVRX4_CFG, dict(front_RBs=1, back_RBs=1, nframes=5), 32, 2),
]


def check_backward_x4():
    """dcn_bwd against its plain version at the EDVR x4 + TSA recipe's DCN
    planes (X4_BWD_SHAPES), ±8, both forms, bf16 and f32, offsets of std
    2.5 px, with check_backward's tolerances; the separate form's time at
    each plane beside its bound.  Returns {(form, dtype, plane): {output:
    {max_abs_err, tol}}}."""
    import torch

    from realvsr_tpu_torch.ops.kernels.check import (grad_tolerance,
                                                     max_abs_err)
    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_om,
                                                   dcn_bwd_om_plain,
                                                   dcn_bwd_plain)

    r, errs = train_r(), {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for shape in X4_BWD_SHAPES:
            x, off, mask, wgt, gout = dcn_bwd_inputs(shape, dtype, 31,
                                                     on_card=True)
            om = om_of(off, mask)
            for form, names, kernel, plain, args in (
                    ("separate", ("dx", "doffset", "dmask", "dweight"),
                     dcn_bwd, dcn_bwd_plain, (x, off, mask, wgt, gout)),
                    ("om", ("dx", "dom", "dweight"), dcn_bwd_om,
                     dcn_bwd_om_plain, (x, om, wgt, gout))):
                out = kernel(*args, 8, r)
                torch.cuda.synchronize()
                ref = plain(*args, 8, r)
                row = {}
                for name, o, rf in zip(names, out, ref):
                    err, tol = max_abs_err(o, rf), grad_tolerance(rf)
                    row[name] = dict(max_abs_err=err, tol=tol)
                    if not (o.dtype == rf.dtype and o.shape == rf.shape
                            and err <= tol and torch.isfinite(o).all()):
                        raise AssertionError(
                            f"dcn_bwd x4 {form} {name} {dname} {shape}: "
                            f"{err} > {tol}")
                timing = {}
                if form == "separate":   # as time_dcn_bwd bounds it
                    p = shape[0] * shape[1] * shape[2]
                    b_ms, b_by = bound(nbytes(*args, *out), 4 * p * 576 * 64,
                                       20 * p * 576, dname)
                    timing = dict(ms=cuda_ms(lambda: kernel(*args, 8, r), 5),
                                  bound_ms=b_ms, bound_by=b_by)
                emit(check="dcn_bwd", case="EDVR x4 recipe plane",
                     form=form, shape=shape, dtype=dname, max_offset=r,
                     **row, **timing)
                errs[(form, dname, shape[1])] = row
                del out, ref
            del x, off, mask, om, gout
            torch.cuda.empty_cache()
    return errs


def family_smoke_training(tmp):
    """``configs/train/smoke_TDAN_motion.yml`` and
    ``smoke_EDVRx4_motion.yml`` as the training command line runs them
    (bf16, their batch, crops and data; weights as initialised), with
    ``niter`` (and the cosine period) cut to SMOKE_ITERS and validation and
    a checkpoint at the end; through :func:`run_trainer`, launches held to
    FAMILY_STEP.  Their motion frames are generated before the run."""
    from realvsr_tpu_torch.core.config import parse

    out = {}
    for name, cfg in (("tdan", TDAN_SMOKE), ("edvr_x4", EDVRX4_SMOKE)):
        opt = parse(os.path.join(ROOT, cfg), is_train=True,
                    root=os.path.join(tmp, f"smoke_{name}"))
        opt["train"].update(niter=SMOKE_ITERS, val_freq=SMOKE_ITERS,
                            T_period=[SMOKE_ITERS])
        opt["logger"].update(print_freq=SMOKE_ITERS // 3,
                             save_checkpoint_freq=SMOKE_ITERS)
        warm = warm_motion(opt)
        res = run_trainer(opt, FAMILY_STEP[name])
        first, last = res["losses"][0], res["losses"][-1]
        emit(phase="training_smoke", path=name, config=cfg,
             dtype="bfloat16", data_setup_s=warm, first_loss=first,
             last_loss=last, **res)
        if [a for a, _ in res["validation_psnr"]] != [SMOKE_ITERS]:
            raise AssertionError(f"{name}: validation "
                                 f"{res['validation_psnr']}")
        if not {f"{SMOKE_ITERS}_G.pth", "latest_G.pth"} <= set(
                res["checkpoints"]):
            raise AssertionError(f"{name}: checkpoints {res['checkpoints']}")
        out[name] = res
    return out


def family_recipe_training(tmp, profile=False):
    """The published recipes' networks and batches through the port's
    Trainer, f32 and bf16: ``train_TDAN_RealVSR_YCbCr_Split.yml`` (192² x
    32, 3 frames) and ``train_EDVRx4_TSA_Vimeo90K.yml`` (GT 256² x 32, LQ
    64², 7 frames), on SyntheticMotion in place of RealVSR / Vimeo90K (not
    in the repo), offsets randomised, RECIPE_STEPS steps after their data is
    generated.  The x4 recipe runs without its augmentation: its cutblur
    branch swaps patches of GT and LQ of one size, and raises at x4 (in the
    reference and the JAX package too).  With ``profile`` the last two
    steps are traced."""
    import torch

    out = {}
    torch.backends.cudnn.allow_tf32 = True   # as the recipes run
    for name, recipe in (("tdan", TDAN_CFG), ("edvr_x4", EDVRX4_CFG)):
        for dtype in ("float32", "bfloat16"):
            opt = _train_opt(tmp, dtype, recipe, mode="SyntheticMotion",
                             steps=RECIPE_STEPS)
            if opt["scale"] > 1:   # cutblur swaps same-size patches
                opt["augment"] = None
            warm = warm_motion(opt)
            res = run_trainer(opt, FAMILY_STEP[name], offsets_seed=11,
                              profile=profile)
            summary = res.pop("profile", None)
            emit(phase="training_recipe", path=name, config=recipe,
                 dtype=dtype, data="SyntheticMotion", data_setup_s=warm,
                 augment=opt["augment"], **res)
            if summary:
                print(f"--- torch.profiler, training {name} {dtype}\n"
                      f"{summary}")
            out[(name, dtype)] = res
    torch.backends.cudnn.allow_tf32 = False
    return out


def peak_gib():
    import torch

    return torch.cuda.max_memory_allocated() / 2 ** 30


def hold_close(what, out, ref, rel=STREAM_REL, **info):
    """``out`` within ``rel`` of ``ref``'s largest magnitude (both on the
    host in f32); emits the largest difference seen."""
    import torch

    top = ref.abs().max().item()
    err = (out - ref).abs().max().item()
    emit(check=what, max_abs_err=err, tol=rel * top, ref_abs_max=top,
         bit_equal=bool(torch.equal(out, ref)), **info)
    if not (out.shape == ref.shape and torch.isfinite(out).all()
            and err <= rel * top):
        raise AssertionError(f"{what}: {err} > {rel * top}")


def streaming_phase(paths, tmp):
    """StreamingRunner at full width with the inference phase's weights:
    the flagship on its 5-frame 1024x512 clip (run, run_lazy, run_scan,
    run_scan_clips) and EDVR x4 + TSA on its 7-frame 448x256 clip (run),
    each against the sliding window that evaluate_wo_gt runs
    (make_forward + sliding_window_infer); the counts set to 0 just before
    each run and held to one pyramid per new frame and one fuse per output
    frame.  Then the timed stream: run_scan on a 12-frame 1024x512 clip and
    run_scan_clips on two, beside one window's forward and the pyramid and
    fuse halves of it."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.data.imageio import read_img_seq
    from realvsr_tpu_torch.eval.sliding_window import (make_forward,
                                                       sliding_window_infer)
    from realvsr_tpu_torch.eval.streaming import StreamingRunner

    launches = {}
    for name in ("edvr_noup", "edvr_x4"):
        model, lq, n, _, _ = paths[name]
        frames = read_img_seq(os.path.join(lq, "000"), color="YCbCr")
        t = frames.shape[0]
        ref = torch.stack([torch.from_numpy(o) for _, o in
                           sliding_window_infer(make_forward(model), frames,
                                                n, device="cuda")])
        runner = StreamingRunner(model, device="cuda")
        zero_counts()
        out = runner.run(frames)
        torch.cuda.synchronize()
        got = read_counts()
        expect = {k: t * (PYRAMID.get(k, 0) + fuse_counts(name).get(k, 0))
                  for k in counters()}
        emit(phase="path", path=f"streaming_{name}", frames=t,
             launches=got, launches_expected=expect)
        if got != expect:
            raise AssertionError(f"streaming {name}: launches {got}, "
                                 f"expected {expect}")
        launches[f"streaming_{name}"] = got
        # one pyramid and one fuse on their own: the split of a window
        one = runner._frames(frames[:1])
        zero_counts()
        pyr = runner._pyramid(one)
        torch.cuda.synchronize()
        split = {"pyramid": read_counts()}
        zero_counts()
        runner._fuse((pyr,) * n, one)
        torch.cuda.synchronize()
        split["fuse"] = read_counts()
        want = {"pyramid": {k: PYRAMID.get(k, 0) for k in counters()},
                "fuse": {k: fuse_counts(name).get(k, 0) for k in counters()}}
        emit(phase="streaming_split", path=name, launches=split)
        if split != want:
            raise AssertionError(f"streaming {name}: {split}, expected "
                                 f"{want}")
        out = out.float().cpu()
        hold_close(f"streaming_{name}_run_vs_sliding_window", out, ref,
                   frames=t, shape=list(out.shape))
        lazy = torch.stack(list(runner.run_lazy(frames))).float().cpu()
        hold_close(f"streaming_{name}_lazy_vs_run", lazy, out)
        if n != 3:
            continue
        zero_counts()
        scan = runner.run_scan(frames)
        torch.cuda.synchronize()
        if read_counts() != expect:
            raise AssertionError(f"run_scan {name}: launches {read_counts()}")
        scan = scan.float().cpu()
        hold_close(f"streaming_{name}_scan_vs_run", scan, out)
        clips = np.stack([frames, frames[::-1]])
        both = runner.run_scan_clips(clips).float().cpu()
        for b in range(2):
            hold_close(f"streaming_{name}_clips_vs_scan", both[b],
                       runner.run_scan(clips[b]).float().cpu(), clip=b)

    # times, bf16, the flagship: a 12-frame clip and two
    model, lq, n, hw, _ = paths["edvr_noup"]
    long_clip = write_clip(tmp, seed=40, frames=STREAM_FRAMES)
    frames = read_img_seq(os.path.join(long_clip, "000"), color="YCbCr")
    runner = StreamingRunner(model, device="cuda")
    fr = torch.from_numpy(frames).cuda()
    clips = torch.stack([fr, fr.flip(0)])
    rows = {}
    for key, fn, count in (
            ("run_scan", lambda: runner.run_scan(fr), STREAM_FRAMES),
            ("run_scan_clips_2", lambda: runner.run_scan_clips(clips),
             2 * STREAM_FRAMES)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fn, 3, warmup=1)
        rows[key] = dict(ms=ms, frames=count, frames_per_s=count / ms * 1e3,
                         peak_mem_gib=peak_gib())
    one = runner._frames(frames[:1])
    window = runner._frames(frames[:n])[None]
    with torch.inference_mode():
        pyr = runner._pyramid(one)
        rows["window_forward_ms"] = cuda_ms(lambda: model(window), 10)
        rows["pyramid_ms"] = cuda_ms(lambda: runner._pyramid(one), 10)
        rows["fuse_ms"] = cuda_ms(lambda: runner._fuse((pyr,) * n, one), 10)
    emit(timing="streaming", path="edvr_noup", resolution=f"{hw[1]}x{hw[0]}",
         dtype="bfloat16", **rows)
    return launches, rows


def tiled_phase(paths, tmp):
    """The flagship at 1920x1088 in 576x1024 tiles, overlap 32 (4 tiles):
    make_batched_tiled_forward (its launches one model call's) against
    tiled_forward, and both against the full-frame forward on the pixels
    farther than receptive_field_rows(5, 10, 4) from every inner tile
    edge; then --flip_test at 1024x512 through the test CLIs' restorer
    against the mean of the four flipped forwards; times of each."""
    import torch

    from realvsr_tpu_torch.eval.sliding_window import (flipx4_forward,
                                                       make_forward)
    from realvsr_tpu_torch.eval.tiled import (make_batched_tiled_forward,
                                              make_tiled_forward,
                                              receptive_field_rows,
                                              tile_grid)
    from realvsr_tpu_torch.data.imageio import read_img_seq
    from realvsr_tpu_torch.tools._cli import parse_args, restorer

    model, lq, n, hw, _ = paths["edvr_noup"]
    hd = write_clip(tmp, seed=41, frames=n, h=HD[0], w=HD[1])
    window = read_window(hd, n)[0]                       # (3, 1088, 1920, 3)
    batched = make_batched_tiled_forward(model, tile_hw=TILE_HW,
                                         overlap=TILE_OVERLAP, device="cuda")
    loop = make_tiled_forward(model, tile_hw=TILE_HW, overlap=TILE_OVERLAP,
                              device="cuda")
    zero_counts()
    out = batched(window)
    torch.cuda.synchronize()
    got = read_counts()
    expect = dict(EXPECT["edvr_noup"], dcn_bwd=0, dcn_block=0)
    (th, tw), tiles = tile_grid(*HD, TILE_HW, TILE_OVERLAP)
    emit(phase="path", path="tiled_1080p", tiles=len(tiles), launches=got,
         launches_expected=expect)
    if got != expect or len(tiles) != 4:
        raise AssertionError(f"tiled: {len(tiles)} tiles, launches {got}")
    out = out.float().cpu()
    hold_close("tiled_batched_vs_loop", out, loop(window), tiles=len(tiles))
    forward = make_forward(model)
    full = forward(window).float().cpu()
    rf = receptive_field_rows(5, 10, R_INFER)
    keep = torch.zeros(HD, dtype=torch.bool)
    for ty, tx, (vy0, vy1, vx0, vx1) in tiles:
        ys = torch.arange(vy0, vy1)[:, None]
        xs = torch.arange(vx0, vx1)[None, :]
        far = torch.ones(vy1 - vy0, vx1 - vx0, dtype=torch.bool)
        if ty > 0:
            far &= ys - ty >= rf
        if ty + th < HD[0]:
            far &= ty + th - 1 - ys >= rf
        if tx > 0:
            far &= xs - tx >= rf
        if tx + tw < HD[1]:
            far &= tx + tw - 1 - xs >= rf
        keep[vy0:vy1, vx0:vx1] = far
    hold_close("tiled_vs_full_frame_beyond_receptive_field", out[keep],
               full[keep], receptive_field_rows=rf,
               pixels_compared=int(keep.sum()), of=keep.numel())

    # --flip_test at 1024x512: the restorer's frame 1 (window 0, 1, 2)
    frames = read_img_seq(os.path.join(lq, "000"), color="YCbCr")
    restore = restorer(parse_args(["-opt", "test.yml", "--flip_test"], ""),
                       {"datasets": {"test": {}}, "network_G": {"nframes": n}},
                       model)
    flipped = dict(restore(frames))[1]
    w3 = torch.from_numpy(frames[:n]).cuda()
    with torch.inference_mode():
        mean = sum(forward(w3.flip(d)).float().flip(d) if d else
                   forward(w3).float() for d in ((), (-2,), (-3,), (-3, -2)))
    hold_close("flip_test_vs_four_flipped_forwards",
               torch.from_numpy(flipped), mean.cpu() / 4)

    rows = {}
    for key, fn, count in (
            ("tiled_batched_1080p", lambda: batched(window), 1),
            ("full_frame_1080p", lambda: forward(window), 1),
            ("flip_test_1024x512", lambda: flipx4_forward(forward, w3), 1)):
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(fn, 3, warmup=1)
        rows[key] = dict(ms=ms, frames_per_s=count / ms * 1e3,
                         peak_mem_gib=peak_gib())
    emit(timing="tiled", tile=TILE_HW, overlap=TILE_OVERLAP, tiles=len(tiles),
         dtype="bfloat16", **rows)
    return {"tiled_1080p": got}, rows


def write_libsvm(tmp):
    """A libsvm model (3 seeded support vectors) and range file in the
    BRISQUE release's format (the card's machine has no scikit-learn to
    fit one)."""
    import numpy as np

    rng = np.random.default_rng(42)
    sv, coef = rng.random((3, 36)), rng.normal(0, 1, 3)
    lines = ["svm_type epsilon_svr", "kernel_type rbf", "gamma 0.05",
             "nr_class 2", "total_sv 3", "rho -0.3", "SV"]
    lines += [" ".join([f"{c:.8f}"] + [f"{j + 1}:{v[j]:.8f}"
                                        for j in range(36)])
              for c, v in zip(coef, sv)]
    mp, rp = os.path.join(tmp, "allmodel"), os.path.join(tmp, "allrange")
    with open(mp, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(rp, "w") as f:
        f.write("\n".join(["-1 1"] + [f"{j + 1} {-1.0 - j / 36} {3.0 + j}"
                                      for j in range(36)]) + "\n")
    return mp, rp


def metrics_phase(paths, tmp):
    """LPIPS and DISTS with seeded random VGG16 weights on a batch of two
    1024x512 frames (the clip and a noisy copy), the card against the CPU
    in f32 (METRIC_REL); NIQE fitted by fit_niqe_model on the clip's
    frames and BRISQUE with a libsvm file written here, the card against
    the CPU in float64; times per 1024x512 frame."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.data.imageio import read_gray
    from realvsr_tpu_torch.eval import brisque, niqe, perceptual

    _, lq, _, hw, _ = paths["edvr_noup"]
    x = read_window(lq, 2)[0]
    g = torch.Generator(device="cuda").manual_seed(43)
    y = (x + 0.05 * torch.randn(x.shape, generator=g, device="cuda")).clamp(
        0, 1)
    card = perceptual.init_lpips_params(with_dists=True, device="cuda")
    cpu = perceptual.init_lpips_params(with_dists=True, device="cpu")
    rows = {}
    for name, fn in (("lpips", perceptual.lpips), ("dists", perceptual.dists)):
        on_card = fn(card, x, y).cpu()
        on_cpu = fn(cpu, x.cpu(), y.cpu())
        err = ((on_card - on_cpu).abs() / on_cpu.abs()).max().item()
        emit(check=f"{name}_card_vs_cpu", scores_card=on_card.tolist(),
             scores_cpu=on_cpu.tolist(), max_rel_err=err, tol=METRIC_REL)
        if not err <= METRIC_REL:
            raise AssertionError(f"{name}: card vs CPU {err}")
        torch.cuda.reset_peak_memory_stats()
        rows[name] = dict(ms_per_frame=cuda_ms(lambda: fn(card, x[:1], y[:1]),
                                               5),
                          peak_mem_gib=peak_gib())
    model_card = niqe.fit_niqe_model(lq, device="cuda")
    model_cpu = niqe.fit_niqe_model(lq, device="cpu")
    mu_err = float(np.abs(model_card["mu"] - model_cpu["mu"]).max()
                   / np.abs(model_cpu["mu"]).max())
    mp, rp = write_libsvm(tmp)
    svm = brisque.load_libsvm_model(mp, rp)
    img = read_gray(os.path.join(lq, "000", "00002.png"))
    scores = {}
    for name, fn in (("niqe", lambda dev: niqe.niqe_score(img, model_cpu,
                                                          device=dev)),
                     ("brisque", lambda dev: brisque.brisque_score(
                         img, svm, device=dev))):
        scores[name] = (fn("cuda"), fn("cpu"))
        torch.cuda.reset_peak_memory_stats()
        rows[name] = dict(ms_per_frame=cuda_ms(lambda: fn("cuda"), 5),
                          peak_mem_gib=peak_gib())
    feats = (brisque.brisque_features(img, "cuda").cpu(),
             brisque.brisque_features(img, "cpu"))
    f_err = ((feats[0] - feats[1]).abs().max()
             / feats[1].abs().max()).item()
    rel = {k: abs(a / b - 1) for k, (a, b) in scores.items()}
    emit(check="no_reference_card_vs_cpu", niqe_mu_max_rel_err=mu_err,
         brisque_features_max_rel_err=f_err, scores=scores,
         score_rel_err=rel, tol_features=1e-6, tol_scores=1e-4)
    if not (mu_err <= 1e-6 and f_err <= 1e-6
            and all(v <= 1e-4 for v in rel.values())):
        raise AssertionError(f"no-reference metrics card vs CPU: {mu_err} "
                             f"{f_err} {rel}")
    emit(timing="metrics", resolution=f"{hw[1]}x{hw[0]}", **rows)
    return rows


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
    logs = _build.build(["dcn_fwd", "conv3x3", "conv3x3_sync", "dcn_bwd",
                         "dcn_narrow"])
    for src, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {src}.cu\n{log.strip()}")
    emit(phase="build", seconds=time.time() - t0, built=sorted(logs))
    for src, log in logs.items():
        for kernel, regs, stores, loads in ptxas_lines(log):
            emit(ptxas=src, kernel=kernel, registers=regs,
                 spill_stores=stores, spill_loads=loads)
            if src in ("conv3x3", "dcn_fwd", "dcn_bwd", "dcn_narrow") and (
                    stores or loads):
                raise AssertionError(f"{kernel} spills")

    profiling = "--profile" in sys.argv[1:]
    errs = check_kernels()
    bwd_errs = check_backward()
    narrow_errs = check_narrow()
    x4_errs = check_backward_x4()
    with tempfile.TemporaryDirectory() as tmp:
        paths = inference_paths(tmp)
        launches = {p: v[-1] for p, v in paths.items()}
        launches["block_api"] = block_path()
        train = training_slice(tmp, profiling)
        for d in train:
            launches[f"training_{d}"] = train[d]["launches"]
        reduced_train_step()
        launches["training_debug_nf16"], debug_step = narrow_training(tmp)
        reduced_train_step(DEBUG_CFG)
        for recipe, cuts, side, ft in FAMILY_CASES:
            reduced_train_step(recipe, cuts, side, "SyntheticMotion", ft,
                               spread=True)
        for fam, res in family_smoke_training(tmp).items():
            launches[f"training_{fam}_smoke"] = res["launches"]
        for (fam, dt), res in family_recipe_training(tmp, profiling).items():
            launches[f"training_{fam}_recipe_{dt}"] = res["launches"]
        for phase in (streaming_phase, tiled_phase):
            launches.update(phase(paths, tmp)[0])
        metrics_phase(paths, tmp)
        rows = time_kernels()
        bwd_rows = time_dcn_bwd()
        rows["dcn_bwd"] = bwd_rows["bfloat16"]
        narrow_rows = time_narrow()
        time_dcnpack()
        for p, (model, lq_root, n, hw, _) in paths.items():
            window = time_path(p, model, lq_root, n, hw)
            if profiling:
                profile(p, model, window)

    bf = torch.bfloat16
    # each kernel's launches on every path; ``launches`` is the one of the
    # path that first put it on a model path (the f32 training run for the
    # flagship's kernels, the recipe's precision)
    by_path = {k: {p: c[k] for p, c in launches.items()} for k in counters()}
    bwd = bwd_errs[("separate", bf, train_r(), False)]

    def c16(kernel):
        """The narrow instantiation's numbers (C = 16 in 4 groups): its
        error at bf16 ±8 (every case beside it), time at the debug shape
        and launches on the debug training path (all and its last
        step's)."""
        by_case = {f"{form} {dt} r={r}": e
                   for (k, form, dt, r), e in narrow_errs.items()
                   if k == kernel}
        return dict(max_abs_err_c16=narrow_errs[(kernel, "separate",
                                                 "bfloat16", train_r())],
                    c16=dict(narrow_rows[(kernel, "bfloat16")],
                             shape=NARROW_SHAPE,
                             launches=by_path[kernel]["training_debug_nf16"],
                             launches_per_step=debug_step[kernel],
                             max_abs_err_by_case=by_case))

    kernels = [
        dict(name="dcn_fwd", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_fwd.cu",
             replaces="realvsr_tpu/ops/pallas/dcn_frame_kernel.py:225",
             launches=by_path["dcn_fwd"]["training_float32"],
             launches_by_path=by_path["dcn_fwd"],
             max_abs_err=errs[("dcn_fwd", "L1", bf, 4)],
             **c16("dcn_fwd"), **rows[("dcn_fwd", "L1", "bfloat16")]),
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
             max_abs_err_by_output=bwd, **c16("dcn_bwd"),
             max_abs_err_x4_planes={
                 f"{form} {dt} {w}x{w}": max(v["max_abs_err"]
                                             for v in row.values())
                 for (form, dt, w), row in x4_errs.items()},
             **rows["dcn_bwd"]),
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
