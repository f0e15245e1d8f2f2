#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``realvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --ab PARENT [TREE ...]   # beside a parent's kernels

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``realvsr_tpu_torch/csrc`` with nvcc, in
   parallel, print ``-Xptxas -v`` and one line per instantiation with its
   registers and spills (a spill in any source fails the run:
   ``conv3x3.cu``, ``dcn_fwd.cu``, ``dcn_bwd.cu``, ``dcn_narrow.cu``);
3. hold each kernel against its plain PyTorch version on the card at the
   paths' shapes, in bf16 and f32, with the tolerances of
   ``realvsr_tpu_torch/ops/kernels/check.py``: the DCN forward at ±4, ±8
   and exact, with separate offsets and mask and with DCNPack's
   offset/mask tensor read in place (``om``), and the 64-out conv3x3 at
   the inference shapes; the conv3x3 at other widths
   (64->3 with and without bias, 64->216 lrelu, 64->256 with a residual at
   EDVR's upconv2 shape, 128 (64+64) -> 3 through two inputs), and one
   narrow shape (16+16 -> 64, 32-byte chunks); the block DCN
   API at the L1 shape clamped to ±4 and ±8; the DCN backward, in both
   forms, at one training sample (3, 192, 192, 64) clamped to ±4, ±8 and
   exact, with offsets of a few pixels (taps outside the image) and with
   zero offsets, each gradient on its own; and the conv3x3 autograd (64-out
   with and without an activation, and 64->3) against autograd of its
   plain version; at the other widths: both DCN kernels at 128 channels in
   8 groups (EDVR-L) at its L1 inference shape (7, 256, 448, 128) and a
   training sample (7, 64, 64, 128), and on the narrow kernels at 32 in 4
   and 8, 48 in 8 and 64 in 4 (the debug shape's pixels), both forms, ±4,
   ±8 and exact, bf16 and f32; the block API at 128 channels ±4; EDVR-L's
   convs (128->128, 256 (128+128)->128, 128->216, 128->256 and upconv1's
   128->512 in two column blocks of 256), a ragged 300-output conv with a
   residual (a last column block of 64), and the nf 16 debug configs'
   narrow convs on 32-byte chunks (16 and 16+16 -> 16, 16 -> 108, 16 ->
   64), each with the route it took;
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
   - EDVR-L, the x4 + TSA recipe's network at nf 128 with 40 back
     ResBlocks (5 front, 8 groups, 7 frames), on EDVR x4's 7-frame 448x256
     clip, then at 32x32 card vs CPU;
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
   - EDVR-L on the x4 recipe's batch the same way, and one Split step at
     full width and cut depth (1 + 1 ResBlocks, 5 frames, LQ 32x32) card
     vs CPU;
8. the GAN and the other generators:
   - ``flow_warp`` (both paddings) and FSTRN's trilinear residual in f32
     on the card against the CPU;
   - TOF, FSTRN and RCAN as their Split recipes give them (full width and
     depth), bf16, through ``evaluate_wo_gt`` on the 1024x512 clip with the
     conv3x3 launches per window held to their routing, timed, and at a
     reduced size card vs CPU; one Split step of each at full width and
     cut depth, card vs CPU (as the families' steps);
   - one GAN-Split step of ``train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml``
     (G at full width and depth, D nf 64) at 64x64, card vs CPU, D's
     gradients and running statistics included;
   - that recipe through the port's Trainer at its 192² x 32 batch, f32
     (TF32) and bf16, ±8, offsets randomised, its cutblur on, 8 steps (cuts:
     ``Synthetic`` data, ``pretrain_model_G: null``, no validation), the
     Split step's launches a step exactly (D runs no kernel), every loss
     and ``g_active`` a step;
   - ``configs/train/debug_EDVR-GAN_Split_synthetic.yml`` as the command
     line runs it (16 iterations, nf 16 on ``csrc/dcn_narrow.cu``,
     validation and G / D checkpoints at 8 and 16), then a resume from 8;
   - ``smoke_{TOF,FSTRN,RCAN}_motion.yml`` cut to 12 iterations with
     validation and a checkpoint, and the three Split recipes' networks and
     batches (192² x 32, 3 frames) on motion-synthetic data, 6 steps each in
     f32 and bf16;
9. times: each kernel, its plain version and the one PyTorch call that
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
   memory of each; at the other widths both DCN kernels at 128 channels
   (the forward at EDVR-L's L1 inference shape, the backward at its L1
   training shape (224, 64, 64, 128)) and on the narrow kernels, beside
   their plain versions and bounds, EDVR-L's convs, the 300-output conv
   and the debug configs' narrow convs beside cuDNN (and, from
   torch.profiler, each one's device-only time beside cuDNN's), EDVR-L's
   forward ms, frames/s and peak memory; each conv whose weight is
   streamed (``conv3x3.cu`` note 7) with its plan and its time per weight
   slice, and each path's and training run's launches of such convs a
   window / a step by shape (``streamed_per_window``,
   ``streamed_per_step``);
10. multi-process training and the rest of the JAX package (run after
    phase 6's metrics, before phase 9's times); ranks are this script
    started again (``--worker <args.json>``) with torchrun's environment:
    a. the flagship's Split recipe (192² x 32, ±8, offsets randomised,
       ``Synthetic`` data) on one rank over NCCL: one step of the recipe's
       Trainer on a fixed global batch held against the single-process
       Trainer's step (gradients within phase 5's 5e-2 of their largest,
       parameters within 2 LR), then DP_STEPS steps in f32 and in bf16 with
       the launches a step of phase 5;
    b. the same on two ranks over gloo on the one card (16 a rank): the
       fixed step against (a)'s, the ranks' parameters bit-identical after
       the runs, steps/s and peak memory per rank;
    c. one GAN-Split step of the GAN recipe (``ragan``, D's BatchNorms; G at
       full width and depth, D nf 64) at 64x64 on two gloo ranks against
       the one-rank step on the same global batch of 4: G's and D's
       gradients and D's running statistics within GAN_DP_TOL;
    d. ``eval/spatial.py``: ``spatial_sharded_forward`` of the flagship
       (bf16, ±4, default halo 128 rows) at 1920x1088 on two gloo ranks,
       and ``shard_forward`` of 4 shards in this process, each against the
       full-frame forward on every row and with the launches a shard held
       to the model's routing; times beside the full frame's;
    e. ``tools/validate_dcn_clamp.py`` on the 1024x512 clip's first window
       at ±4 and ±8 (f32; ``dcn_fwd`` and ``dcn_block`` launches counted)
       and ``SRMDPreprocessing`` (x4, l = 21, noise off) of a 32 x 192²
       batch, the card against the CPU.

11. the DCN kernels over the TPU kernel's whole domain and the paths that
    had only CPU parity (the checks after phase 3's, the general path after
    the block API, the recipes after phase 8's, the test CLI after phase
    6's metrics, the times after phase 9's widths):
    a. ``csrc/dcn_narrow.cu`` forward and backward at 64 -> 32 and 32 ->
       64 in 8 groups with and without a mask, 96 in 4 groups, 256 in 8
       and DCNv1 64 -> 64 in 8 (the general path's pixels, both forms
       where there is a mask, ±4 and exact, bf16 and f32) against their
       plain versions, and ``DeformConvModule`` (DCNv1) at 3x3 / p1 (the
       kernels) and p0 (the plain op, against the CPU);
    b. the general DCN surface as a user calls it (DCNPacks at 64 -> 32
       and 256 -> 256, a DCNPack at kernel size 5, DeformConvModule at p1
       and p0) forward and backward on the card, launches held exactly,
       the kernel modules' outputs and gradients held against the plain
       op on the same inputs;
       the times of 128 -> 64, 256 -> 256 and DCNv1 64 -> 64 beside their
       plain versions and bounds, and of DCNv1 64 -> 64 at the flagship's
       L1 (3, 512, 1024, 64) beside the wgmma pair's DCNv2 there;
    c. the Combine wrapper (``train_EDVR_woTSA_RealVSR_YCbCr_Combine.yml``)
       and the bare ``VideoSR_AllPair`` step (``train_EDVR_woTSA_Vimeo90K
       .yml`` on SyntheticMotion): one step at 64x64 card vs CPU, then the
       recipe's 192² x 32 batch through the Trainer, f32 and bf16,
       RECIPE_STEPS steps;
    d. ``train_TOF-GAN_RealVSR_YCbCr_Split.yml``: one GAN step at 64x64
       card vs CPU (gradients and running statistics of G's SpyNet BN and
       D's), then its batch through the Trainer, f32 and bf16, GAN_STEPS
       steps;
    e. ``tools/test_wi_gt.py`` (``evaluate_wi_gt``'s CLI) with
       ``test_EDVR_woTSA_RealVSR_wi_GT.yml`` (a 5-frame 1024x512 clip) and
       ``test_synthetic_motion_wi_GT.yml`` (4 x 20 frames at 256x256 from
       ``dump_synthetic_testset``), seeded weights, bf16, ±4, launches per
       window held; then a 3-frame 64x128 clip card vs CPU in f32, the
       PSNR / SSIM within WI_GT_TOL.

Prints one JSON line per check and timing, then the card line, the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": ...}``.
``--ab PARENT [TREE ...]`` builds ``conv3x3.cu`` and ``dcn_fwd.cu`` of the
tree unpacked at PARENT (the parent commit, with its signatures), and
``conv3x3.cu`` of each further TREE (ablations: copies of this tree's
sources with a change), and times every conv whose weight is streamed
(AB_STREAMED: EDVR-L's 128-wide convs but upconv1, the flagship's PCD L1
(64+64) -> 64, 64 -> 216 and 64 -> 256; each with its time per weight slice
and cuDNN + act beside) and the controls (the front 64 -> 64, upconv1's
column blocks, the debug 16 -> 16 on 32-byte chunks, the C 64 DCN forward
at L1) beside this tree's, bf16 and f32, in
turns (parent, this, this, parent), then stops.  ``--profile`` adds a
``torch.profiler`` breakdown of one window's forward
of each inference model and of the last two steps of each timed training
run (the flagship's, the families' and the new generators' recipes, the
GAN's).
"""
from __future__ import annotations

import contextlib
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


def device_ms(fn, iters: int) -> float | None:
    """Mean device time of ``fn()``'s kernels over ``iters`` calls from
    torch.profiler (the sum of every kernel's self device time), without
    the host's pacing and the gaps between launches; None where the
    profiler records no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile as prof,
                                record_function)

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(iters):
            with record_function("call"):  # the kernels' launching op
                fn()
        torch.cuda.synchronize()
    # the kernels' own rows: an op's row repeats its kernels' time, and
    # the annotation's device row spans them and the gaps between them
    us = sum(e.self_device_time_total for e in p.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA
             and e.key != "call")
    return us / iters / 1e3 if us else None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def counters() -> dict:
    """Every kernel wrapper, by its row name in the kernels line; each
    counts its own launches in ``.launches``."""
    from realvsr_tpu_torch.ops.deform_conv_block import (
        modulated_deform_conv_block)
    from realvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3,
                                                       conv3x3_fused,
                                                       conv3x3_narrow)
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_bwd, dcn_fwd

    return {"dcn_fwd": dcn_fwd, "conv3x3": conv3x3,
            "conv3x3_fused": conv3x3_fused, "dcn_bwd": dcn_bwd,
            "dcn_block": modulated_deform_conv_block,
            "conv3x3_narrow": conv3x3_narrow}


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


def streamed_info(shape, c2, cout, dtype, residual=False) -> dict:
    """Where a conv's weight is streamed (``conv3x3.cu`` note 7): its plan
    (halo stages, weight slots, in clusters or not); the timing row adds
    its time per weight slice (:func:`per_slice_us`)."""
    from realvsr_tpu_torch.ops.kernels.conv3x3 import stream_plan

    plan = stream_plan(shape[3], c2, cout, dtype, residual)
    return {} if plan is None else dict(streamed=plan._asdict())


@contextlib.contextmanager
def streamed_tally():
    """Counts the models' convs (``models/common.py``'s
    ``conv3x3_autograd``) whose weight is streamed (``conv3x3.cu`` note 7),
    by input and output widths and dtype, while the block runs: the
    launches a window or a step of each streamed shape (each such call is
    one launch of the kernel)."""
    from collections import Counter

    from realvsr_tpu_torch.models import common
    from realvsr_tpu_torch.ops.kernels.conv3x3 import stream_plan

    tally, inner = Counter(), common.conv3x3_autograd

    def counted(x, weight, bias=None, act=None, residual=None, x2=None):
        c2 = 0 if x2 is None else x2.shape[-1]
        if x.is_cuda and stream_plan(x.shape[-1], c2, weight.shape[0],
                                     x.dtype) is not None:
            tally[f"{x.shape[-1]}+{c2}->{weight.shape[0]} "
                  f"{str(x.dtype)[6:]}"] += 1
        return inner(x, weight, bias, act, residual, x2)

    common.conv3x3_autograd = counted
    try:
        yield tally
    finally:
        common.conv3x3_autograd = inner


def add_slice_us(row, shape, c2, dtype) -> dict:
    """The row with its time per weight slice where its conv is streamed."""
    if "streamed" in row:
        row["slice_us"] = per_slice_us(row["ms"], shape, c2, dtype)
    return row


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
        # input widths that are not whole 128-byte chunks: the same kernel
        # on 32-byte chunks (csrc/conv3x3.cu, conv3x3_narrow), ragged tiles
        x, x2, wgt, bias, res = conv_inputs((2, 37, 45, 16), 16, True, dtype,
                                            4)
        out = conv3x3(x, wgt, bias, "relu", res, x2)
        torch.cuda.synchronize()
        ref = conv3x3_plain(x, wgt, bias, "relu", res, x2)
        hold(("conv3x3_narrow", dtype), out, ref,
             case="16+16->64 relu +res", shape=(2, 37, 45, 16),
             route="wgmma, 32-byte chunks")
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


def bn_fed(name: str, names) -> bool:
    """Whether parameter ``name`` is the bias of a conv whose output a
    BatchNorm normalises (``<m>.conv{i}.bias`` beside ``<m>.bn{i}``): its
    gradient is zero but for rounding, so it is held against the model's
    largest gradient, not its own."""
    pre, _, leaf = name.rpartition(".")
    return leaf == "bias" and pre.replace(".conv", ".bn") + ".weight" in names


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
# TDAN's reconstruction and final_conv and EDVR's upconv1 and upconv2.  No
# conv of these paths has narrow inputs (conv3x3_narrow).
EXPECT = {
    "edvr_noup": {"dcn_fwd": 4, "conv3x3": 41 + 4, "conv3x3_fused": 4 + 1,
                  "conv3x3_narrow": 0},
    "tdan": {"dcn_fwd": 4, "conv3x3": 10 + 1 + 4 + 20,
             "conv3x3_fused": 4 + 2, "conv3x3_narrow": 0},
    "edvr_x4": {"dcn_fwd": 4, "conv3x3": 41 + 4 + 6,
                "conv3x3_fused": 4 + 3, "conv3x3_narrow": 0},
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
    with streamed_tally() as tally:
        res = evaluate_wo_gt(model, None, lq_root, n_frames=n_frames,
                             save_folder=out_dir)
    torch.cuda.synchronize()
    launches = read_counts()
    per_window = {k: v / clip for k, v in launches.items()}
    emit(phase="path", path=name, windows=clip, launches=launches,
         launches_per_window=per_window,
         streamed_per_window={k: v / clip for k, v in tally.items()},
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
                profile=False, backend=None):
    """``opt`` through the port's Trainer on the card, as the training
    command line runs it (DCN clamp ±8).  The counts are set to 0 just
    before the run and read just after; each step's launches are held to
    ``per_step``, its losses must be finite, every parameter must move and
    every validation be finite.  Steps after ``warmup`` are timed start to
    end (the host loader included); the gaps between one step's end and the
    next one's start on the device's clock are its idle time.  With
    ``offsets_seed`` the DCN offset convs are randomised first; with
    ``profile`` the last two steps are traced (and then the steps/s is not
    the one to report).  A GAN's D is held with G: every parameter of both
    must move.  Under torchrun's environment the Trainer joins the process
    group over ``backend``; the result then also carries the SHA-256 of
    every parameter after the run (the ranks must agree bit for bit)."""
    import hashlib

    import torch

    from realvsr_tpu_torch.train.trainer import Trainer

    trainer = Trainer(opt, device="cuda", dcn_max_offset=train_r(),
                      backend=backend)
    niter = int(opt["train"]["niter"])
    if profile:
        trainer.profile_steps = (niter - 2, niter)
    if offsets_seed is not None:
        randomise_offset_convs(trainer.model, seed=offsets_seed, std=0.5)
    nets = {"G": trainer.model, "D": trainer.model_d}
    named = {f"{n}.{k}": v for n, net in nets.items() if net is not None
             for k, v in net.named_parameters()}
    before = {k: v.detach().clone() for k, v in named.items()}
    kernels, steps, vals = counters(), [], []
    inner, inner_val = trainer.train_step, trainer.validate

    def step(state, batch, gen):
        n0 = {k: f.launches for k, f in kernels.items()}
        s0 = tally.copy()  # the streamed convs' calls (validation's apart)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        state, logs = inner(state, batch, gen)
        t1.record()
        steps.append(dict(
            launches={k: f.launches - n0[k] for k, f in kernels.items()},
            streamed=dict(tally - s0), logs=logs, start=t0, end=t1))
        return state, logs

    def validate(at):
        psnr = inner_val(at)
        vals.append((at, psnr))
        return psnr

    trainer.train_step, trainer.validate = step, validate
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    with streamed_tally() as tally:
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
                for k, v in named.items())
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
        streamed_per_step=steps[-1]["streamed"],
        losses=[{k: v.item() for k, v in st["logs"].items()} for st in steps],
        steps_per_s=len(timed) / (ms / 1e3), step_ms=step_ms,
        median_step_ms=sorted(step_ms[warmup:])[len(timed) // 2],
        gap_ms=gaps, idle_share=sum(gaps) / ms, peak_mem_gib=peak,
        params_moved=moved, validation_psnr=vals, profiled=profile,
        checkpoints=sorted(os.listdir(opt["path"]["models"])))
    if torch.distributed.is_initialized():
        h = hashlib.sha256()
        for k in sorted(named):
            h.update(named[k].detach().cpu().numpy().tobytes())
        res["params_sha256"] = h.hexdigest()
    if profile:
        with open(os.path.join(opt["path"]["experiments_root"], "profile",
                               "summary.txt")) as f:
            res["profile"] = f.read()
    del trainer, before, named, nets, steps
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
    """One step of ``recipe``'s network (depth cut by ``cuts``) through its
    wrapper (``make_train_step``'s dispatch on the recipe's ``model``:
    Split, Combine or the bare AllPair) on a batch of 2 with LQ ``side`` x
    ``side`` from the ``mode`` train set, f32:
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
    from realvsr_tpu_torch.train.wrappers import make_train_step

    opt = network_opt(recipe)
    opt.pop("augment")
    opt["network_G"].update(cuts or {})
    opt["train"]["ft_tsa_only"] = ft_tsa_only
    net = opt["network_G"]
    scale, n = opt["scale"] or 1, net.get("nframes") or net["num_frames"]
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
        _, logs = make_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[dev] = logs.get("l_tot", logs["l_pix"]).item()
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
        make_train_step(model, opt)(create_train_state(model, opt), noisy,
                                    torch.Generator())
        cpu_spread = {k: (p.grad - grads["cpu"][k]).abs().max().item()
                 for k, p in model.named_parameters()}
    loss_rel = abs(losses["cuda"] / losses["cpu"] - 1)
    # (error / bound, error relative to the tensor's largest, CPU spread
    # relative to it, name)
    errs = []
    model_top = max(g.abs().max().item() for g in grads["cpu"].values())
    for k, g in grads["cpu"].items():
        top = (model_top if bn_fed(k, grads["cpu"])
               else g.abs().max().clamp_min(1e-30).item())
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
                  dcn_block=1, conv3x3_narrow=0)
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
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                **streamed_info(shape, c2, cout, dtype, residual))
            add_slice_us(row, shape, c2, dtype)
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
NARROW = (16, 4)                 # its width: channels, groups
# per training step of the debug config (nf 16, 1 + 1 ResBlocks), from the
# model's routing: the 64-out conv3x3 is HRconv (16 -> 64); the other widths
# are the ResBlocks' 4 convs, fea_L2_conv2 / fea_L3_conv2, PCD's 10 offset
# convs and L2_fea_conv / L1_fea_conv, the 4 conv_offset_mask (16 -> 108)
# and conv_last; all but conv_last (64 -> 3, HRconv's 64 channels in) have
# 16-wide inputs, which run the kernel on 32-byte chunks (conv3x3_narrow)
DEBUG_STEP = {"dcn_fwd": 4, "dcn_bwd": 4, "conv3x3": 1, "conv3x3_fused": 23,
              "dcn_block": 0, "conv3x3_narrow": 1 + 22}
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


def check_narrow():
    """Both DCN kernels at 16 channels in 4 groups (``csrc/dcn_narrow.cu``,
    the debug configs' width), both forms, bf16 and f32, ±4, ±8 and exact,
    against their plain versions (:func:`hold_dcn_pair`).  Returns
    {(kernel, form, dtype, r): max abs err (largest over the outputs)}."""
    import torch

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for (k, form, r), e in hold_dcn_pair("dcn_narrow", NARROW_SHAPE, 4,
                                             dtype, 21).items():
            errs[(k, form, str(dtype)[6:], r)] = e
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


# --------------------------------------------------------------------------
# The GAN-Split recipe and the other generators: TOF, FSTRN, RCAN.

GAN_CFG = os.path.join("configs", "train",
                       "train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml")
DEBUG_GAN_CFG = os.path.join("configs", "train",
                             "debug_EDVR-GAN_Split_synthetic.yml")
GAN_STEPS = 8          # 6 timed after 2 of warm-up
GAN_CUTS = ["Synthetic data in place of RealVSR (not in the repo)",
            "pretrain_model_G: null (the pretrained G is not in the repo)",
            "no validation", f"{GAN_STEPS} iterations"]
GENERATORS = ("tof", "fstrn", "rcan")
GEN_CFG = {n: os.path.join("configs", "train",
                           f"train_{n.upper()}_RealVSR_YCbCr_Split.yml")
           for n in GENERATORS}
GEN_SMOKE = {n: os.path.join("configs", "train",
                             f"smoke_{n.upper()}_motion.yml")
             for n in GENERATORS}
# per window and per training step (the backward runs cuDNN), from the
# models' routing at the recipes' widths: TOF's MSRResNet trunk (10
# ResBlocks) and HRconv at 64 -> 64, conv_last 64 -> 3 (SpyNet's 7x7 convs
# and conv_first on cuDNN); FSTRN none (3-D convs on cuDNN); RCAN's 5
# groups of 2 RCABs (2 convs each) and a closing conv, conv_after_body,
# conv_last 64 -> 3
EXPECT.update({
    "tof": {"dcn_fwd": 0, "conv3x3": 2 * 10 + 1, "conv3x3_fused": 1,
            "conv3x3_narrow": 0},
    "fstrn": {"dcn_fwd": 0, "conv3x3": 0, "conv3x3_fused": 0,
              "conv3x3_narrow": 0},
    "rcan": {"dcn_fwd": 0, "conv3x3": 5 * (2 * 2 + 1) + 1,
             "conv3x3_fused": 1, "conv3x3_narrow": 0},
})
GEN_STEP = {n: dict(EXPECT[n], dcn_bwd=0, dcn_block=0) for n in GENERATORS}
# card-vs-CPU steps at full width: (depth cuts, LQ side)
GEN_CASES = {"tof": (dict(nb=1), 64), "fstrn": ({}, 64),
             "rcan": (dict(num_group=1, num_block=1), 64)}


def gan_recipe_training(tmp, profile=False):
    """The GAN recipe's G (EDVR_NoUp, nf 64) and D (MultiscaleDiscriminator
    _v4, 2 PatchGANs of nf 64 on the Y pyramid's HF levels, ragan) at its
    192² x 32 batch through the port's Trainer, f32 (TF32, as the recipes
    run) and bf16, offsets randomised, its cutblur on, GAN_STEPS steps; cuts
    GAN_CUTS.  Launches a step are the Split step's: D runs no kernel.
    With ``profile`` the last two steps are traced."""
    import torch

    per_step = dict(EXPECT["edvr_noup"], dcn_bwd=4, dcn_block=0)
    out = {}
    torch.backends.cudnn.allow_tf32 = True
    for dtype in ("float32", "bfloat16"):
        opt = _train_opt(tmp, dtype, GAN_CFG, steps=GAN_STEPS)
        opt["path"]["pretrain_model_G"] = None
        res = run_trainer(opt, per_step, offsets_seed=11, profile=profile)
        summary = res.pop("profile", None)
        emit(phase="training_gan", config=GAN_CFG, dtype=dtype,
             cuts=GAN_CUTS, augment=opt["augment"], **res)
        if summary:
            print(f"--- torch.profiler, training GAN {dtype}\n{summary}")
        if any(s["g_active"] != 1.0 for s in res["losses"]):
            raise AssertionError("a GAN recipe step gated G off")
        out[dtype] = res
    torch.backends.cudnn.allow_tf32 = False
    return out


def gan_debug_training(tmp):
    """``configs/train/debug_EDVR-GAN_Split_synthetic.yml`` as the training
    command line runs it (16 iterations at 64x64 x 4, nf 16 / 4 groups on
    ``csrc/dcn_narrow.cu``, validation and G / D checkpoints at 8 and 16),
    launches held to DEBUG_STEP; then a resume from step 8's state: G, D,
    both optimizers and schedulers back, and on to step 16."""
    import torch

    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train.trainer import Trainer

    root = os.path.join(tmp, "debug_gan")
    opt = parse(os.path.join(ROOT, DEBUG_GAN_CFG), is_train=True, root=root)
    t0 = time.time()
    res = run_trainer(opt, DEBUG_STEP, offsets_seed=22)
    res["seconds"] = time.time() - t0
    emit(phase="training_debug_gan", config=DEBUG_GAN_CFG, **res)
    if [a for a, _ in res["validation_psnr"]] != [8, 16]:
        raise AssertionError(f"validation {res['validation_psnr']}")
    want = {f"{s}_{n}.pth" for s in (8, 16, "latest") for n in "GD"}
    if not want <= set(res["checkpoints"]):
        raise AssertionError(f"checkpoints {res['checkpoints']}")

    opt = parse(os.path.join(ROOT, DEBUG_GAN_CFG), is_train=True, root=root)
    opt["path"]["resume_state"] = os.path.join(
        opt["path"]["training_state"], "8.state")
    trainer = Trainer(opt, device="cuda", dcn_max_offset=train_r())
    back = dict(step=trainer.state.step,
                schedulers=[s.last_epoch for s in trainer.state.schedulers])
    d8 = torch.load(os.path.join(opt["path"]["models"], "8_D.pth"),
                    weights_only=True)
    same_d = all(torch.equal(v.cpu(), d8[k])
                 for k, v in trainer.model_d.state_dict().items())
    zero_counts()
    state = trainer.train()
    torch.cuda.synchronize()
    emit(phase="training_debug_gan_resume", resumed=back, d_restored=same_d,
         final_step=state.step, launches=read_counts())
    if not (back == dict(step=8, schedulers=[8, 8]) and same_d
            and state.step == 16):
        raise AssertionError(f"resume {back} {same_d} {state.step}")
    return res["launches"]


def generator_paths(tmp, clip):
    """TOF, FSTRN and RCAN as their Split recipes give them (full width and
    depth, scale 1, 3 frames), bf16, seeded random weights, through
    ``evaluate_wo_gt`` on the 1024x512 clip with launches per window held
    to EXPECT, then timed (``time_path``) and their reduced forward card vs
    CPU.  Returns {name: (model, launches, window)}."""
    import torch

    from realvsr_tpu_torch.models import define_g

    out = {}
    for i, name in enumerate(GENERATORS):
        opt = network_opt(GEN_CFG[name])

        def build(dev, dtype=torch.float32, seed=40 + i, opt=opt):
            return define_g(opt, device=dev, dtype=dtype,
                            generator=torch.Generator().manual_seed(seed))

        model = build("cuda", torch.bfloat16)
        launches = drive_path(name, model, clip, NFRAMES, CLIP, (H, W), tmp)
        window = time_path(name, model, clip, NFRAMES, (H, W))
        card_vs_cpu(name, build, model, (1, NFRAMES, 64, 128, 3))
        out[name] = (model, launches, window)
    return out


def generator_smoke_training(tmp):
    """``configs/train/smoke_{TOF,FSTRN,RCAN}_motion.yml`` as the training
    command line runs them (bf16, batch 8, 96² crops of 224² motion clips),
    ``niter`` (and the cosine period) cut to SMOKE_ITERS with validation and
    a checkpoint at the end; launches a step held to GEN_STEP."""
    from realvsr_tpu_torch.core.config import parse

    out = {}
    for name in GENERATORS:
        opt = parse(os.path.join(ROOT, GEN_SMOKE[name]), is_train=True,
                    root=os.path.join(tmp, f"smoke_{name}"))
        opt["train"].update(niter=SMOKE_ITERS, val_freq=SMOKE_ITERS,
                            T_period=[SMOKE_ITERS])
        opt["logger"].update(print_freq=SMOKE_ITERS // 3,
                             save_checkpoint_freq=SMOKE_ITERS)
        warm = warm_motion(opt)
        res = run_trainer(opt, GEN_STEP[name])
        emit(phase="training_smoke", path=name, config=GEN_SMOKE[name],
             dtype="bfloat16", data_setup_s=warm,
             first_loss=res["losses"][0], last_loss=res["losses"][-1], **res)
        if [a for a, _ in res["validation_psnr"]] != [SMOKE_ITERS]:
            raise AssertionError(f"{name}: validation "
                                 f"{res['validation_psnr']}")
        if not {f"{SMOKE_ITERS}_G.pth", "latest_G.pth"} <= set(
                res["checkpoints"]):
            raise AssertionError(f"{name}: checkpoints {res['checkpoints']}")
        out[name] = res
    return out


def generator_recipe_training(tmp, profile=False):
    """The Split recipes' networks and batches of TOF, FSTRN and RCAN
    (``train_*_RealVSR_YCbCr_Split.yml``: 192² x 32, 3 frames, their cutblur
    on) through the port's Trainer, f32 (TF32) and bf16, on SyntheticMotion
    in place of RealVSR, RECIPE_STEPS steps after their data is generated.
    With ``profile`` the last two steps are traced."""
    import torch

    out = {}
    torch.backends.cudnn.allow_tf32 = True
    for name in GENERATORS:
        for dtype in ("float32", "bfloat16"):
            opt = _train_opt(tmp, dtype, GEN_CFG[name],
                             mode="SyntheticMotion", steps=RECIPE_STEPS)
            warm = warm_motion(opt)
            res = run_trainer(opt, GEN_STEP[name], profile=profile)
            summary = res.pop("profile", None)
            emit(phase="training_recipe", path=name, config=GEN_CFG[name],
                 dtype=dtype, data="SyntheticMotion", data_setup_s=warm,
                 augment=opt["augment"], **res)
            if summary:
                print(f"--- torch.profiler, training {name} {dtype}\n"
                      f"{summary}")
            out[(name, dtype)] = res
    torch.backends.cudnn.allow_tf32 = False
    return out


def reduced_gan_step(side=64, cfg=GAN_CFG, mode="Synthetic"):
    """One GAN-Split step of ``cfg``'s G (the GAN recipe's EDVR_NoUp, or
    the TOF-GAN recipe's TOF with SpyNet's BatchNorms, at full width and
    depth) and D (nf 64) on a batch of 2 at side x side from the ``mode``
    train set, f32, augmentation off: the card against the CPU from the
    same weights (G's offset convs randomised).  The losses (l_g_total,
    l_d_real, l_d_fake) to 1e-3 relative; each gradient of G and D and
    each running statistic of either after the step to 5e-2 of its largest
    magnitude (a BN-fed bias's gradient to 5e-2 of its model's largest,
    ``bn_fed``) plus the CPU's own change in it under 2^-11 input noise (as
    the families' steps).  Returns the card step's launches."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.data.synthetic import (SyntheticMotionVSRDataset,
                                                  SyntheticVSRDataset)
    from realvsr_tpu_torch.models import define_d, define_g
    from realvsr_tpu_torch.train.gan import (create_gan_train_state,
                                             make_gan_split_train_step)

    opt = network_opt(cfg)
    opt["augment"] = None
    r = train_r()
    ref_g = define_g(opt, device="cpu", dcn_max_offset=r,
                     generator=torch.Generator().manual_seed(12))
    randomise_offset_convs(ref_g, seed=13, std=0.5)
    ref_d = define_d(opt, device="cpu",
                     generator=torch.Generator().manual_seed(14))
    ds = (SyntheticMotionVSRDataset(dict(N_frames=3, GT_size=side, scale=1,
                                         frame_h=side + 32,
                                         frame_w=side + 32))
          if mode == "SyntheticMotion"
          else SyntheticVSRDataset(dict(N_frames=3, GT_size=side)))
    items = [ds.get(i, np.random.default_rng(i)) for i in (3, 17)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}

    def step(dev, b):
        g = define_g(opt, device=dev, dcn_max_offset=r)
        g.load_state_dict(ref_g.state_dict())
        d = define_d(opt, device=dev)
        d.load_state_dict(ref_d.state_dict())
        state = create_gan_train_state(g, d, opt)
        _, logs = make_gan_split_train_step(g, opt)(
            state, {k: v.to(dev) for k, v in b.items()},
            torch.Generator(device=dev))
        vals = {f"G.{k}": p.grad for k, p in g.named_parameters()}
        vals.update({f"D.{k}": p.grad for k, p in d.named_parameters()})
        vals.update({f"{n}.{k}": t for n, m in (("G", g), ("D", d))
                     for k, t in m.named_buffers() if "running" in k})
        return ({k: logs[k].item() for k in ("l_g_total", "l_d_real",
                                             "l_d_fake")},
                {k: v.float().cpu() for k, v in vals.items()})

    cpu_logs, cpu = step("cpu", batch)
    zero_counts()
    card_logs, card = step("cuda", batch)
    launches = read_counts()
    noise = torch.randn(batch["LQs"].shape,
                        generator=torch.Generator().manual_seed(16))
    _, noisy = step("cpu", dict(batch, LQs=batch["LQs"]
                                * (1 + 2.0 ** -11 * noise)))
    loss_rel = max(abs(card_logs[k] / cpu_logs[k] - 1) for k in cpu_logs)
    errs = []   # (error / bound, error relative to the largest, name)
    model_top = {m: max(v.abs().max().item() for k, v in cpu.items()
                        if k.startswith(m) and "running" not in k)
                 for m in ("G.", "D.")}
    for k, v in cpu.items():
        top = (model_top[k[:2]] if bn_fed(k, cpu)
               else v.abs().max().clamp_min(1e-30).item())
        spread = (noisy[k] - v).abs().max().item()
        err = (card[k] - v).abs().max().item()
        errs.append((err / (5e-2 * top + spread), err / top, k))
    errs.sort()
    emit(phase="reduced_gan_step_card_vs_cpu", config=cfg, data=mode,
         shape=list(batch["LQs"].shape), losses_cpu=cpu_logs,
         losses_card=card_logs, loss_rel_err=loss_rel, loss_tol=1e-3,
         worst_rel_err=max(e[1] for e in errs),
         worst=max(errs, key=lambda e: e[1])[2],
         worst_err_over_bound=errs[-1][0], worst_by_bound=errs[-3:],
         tol=5e-2, compared=len(errs), card_launches=launches)
    if not (loss_rel <= 1e-3 and errs[-1][0] <= 1.0):
        raise AssertionError(f"GAN card vs CPU: loss {loss_rel}, "
                             f"{errs[-1]}")
    return launches


def check_warp_trilinear():
    """``ops/warp.flow_warp`` (both paddings, flows of std 3 px, many past
    the edges) and FSTRN's trilinear cross-space residual (x4, half-pixel
    centres) in f32 on the card against the CPU, to 1e-5 of the output's
    largest magnitude."""
    import torch
    import torch.nn.functional as F

    from realvsr_tpu_torch.ops.warp import flow_warp

    g = torch.Generator().manual_seed(50)
    x = torch.randn(4, 96, 128, 3, generator=g)
    flow = torch.randn(4, 96, 128, 2, generator=g) * 3
    vol = torch.rand(2, 3, 3, 48, 64, generator=g)
    cases = {f"flow_warp {p}": (lambda a, b, p=p: flow_warp(a, b, p),
                                (x, flow))
             for p in ("zeros", "border")}
    cases["trilinear x4"] = (lambda v: F.interpolate(
        v, size=(3, 192, 256), mode="trilinear", align_corners=False),
        (vol,))
    for name, (fn, args) in cases.items():
        ref = fn(*args)
        out = fn(*[a.cuda() for a in args]).cpu()
        err = (out - ref).abs().max().item()
        tol = 1e-5 * ref.abs().max().item()
        emit(check="card_vs_cpu", op=name, shape=list(ref.shape),
             max_abs_err=err, tol=tol)
        if not (out.shape == ref.shape and err <= tol):
            raise AssertionError(f"{name}: {err} > {tol}")


# --------------------------------------------------------------------------
# EDVR-L and the DCN at every width: 128 channels in 8 groups on the wgmma
# pair, every other C <= 64 on the narrow kernels, the convs at nf 128.

# EDVR-L: the x4 + TSA recipe's network at the EDVR release's large width
# and depth (nf 128, 40 back ResBlocks; EDVR_Vimeo90K_SR_L), 8 groups
EDVRL_NET = dict(nf=128, back_RBs=40)
# per window, from the routing at nf 128: every 3x3 conv of the trunk,
# PCD and TSA has 128 outputs (conv3x3_fused): the 5 front and 40 back
# ResBlocks' convs (90), fea_L2_conv2 / fea_L3_conv2 (2), PCD's 10 offset
# convs and L2_fea_conv / L1_fea_conv (12), TSA's 6, the 4 conv_offset_mask
# (128 -> 216) and upconv1 (128 -> 512, two column blocks of 256), upconv2
# (128 -> 256) and conv_last (64 -> 3); HRconv alone is 64 -> 64 (conv3x3);
# all on the wgmma kernel
EXPECT["edvr_l"] = {"dcn_fwd": 4, "conv3x3": 1,
                    "conv3x3_fused": 90 + 2 + 12 + 6 + 4 + 3,
                    "conv3x3_narrow": 0}
EDVRL_STEP = dict(EXPECT["edvr_l"], dcn_bwd=4, dcn_block=0)
# (128, 8): EDVR-L's L1 inference shape (7 frames of 256x448) and a
# training sample (7 frames of LQ 64x64); the L1 / cascade backward of a
# batch-32 step
DCN128_SHAPES = [("L infer", (7, VIMEO_H, VIMEO_W, 128)),
                 ("L train sample", (7, 64, 64, 128))]
TRAIN_L1_128 = (224, 64, 64, 128)
NARROW_WIDTHS = [(32, 4), (32, 8), (48, 8), (64, 4)]
UPCONV1 = "L upconv1 128->512 lrelu"
# EDVR-L's conv widths at its window's shapes: (name, shape, c2, cout,
# act, residual)
EDVRL_CONVS = [
    ("L front 128->128 relu", (7, VIMEO_H, VIMEO_W, 128), 0, 128, "relu",
     False),
    ("L front 128->128 +res", (7, VIMEO_H, VIMEO_W, 128), 0, 128, None,
     True),
    ("L PCD L1 256 (128+128)->128 lrelu", (7, VIMEO_H, VIMEO_W, 128), 128,
     128, "lrelu", False),
    ("L 128->216 lrelu", (7, VIMEO_H, VIMEO_W, 128), 0, 216, "lrelu",
     False),
    (UPCONV1, (1, VIMEO_H, VIMEO_W, 128), 0, 512, "lrelu", False),
    ("L upconv2 128->256 lrelu", (1, 2 * VIMEO_H, 2 * VIMEO_W, 128), 0, 256,
     "lrelu", False),
    # not a conv of EDVR-L: more than 256 outputs in a ragged last column
    # block (256 + 64 wide, 44 of its columns used), a residual, H and W
    # ragged against the 8 x 16 tile
    ("300 ragged +res", (2, 37, 45, 128), 0, 300, None, True),
]
# the nf 16 debug configs' convs (their L1 shapes: 4 clips x 3 frames at
# 64x64), whose 16-wide inputs run the kernel on 32-byte chunks
# (conv3x3_narrow)
SYNC_CASES = [
    ("debug ResBlock 16->16 relu", (12, 64, 64, 16), 0, 16, "relu", False),
    ("debug PCD offset (16+16)->16 lrelu", (12, 64, 64, 16), 16, 16,
     "lrelu", False),
    ("debug conv_offset_mask 16->108 lrelu", (12, 64, 64, 16), 0, 108,
     "lrelu", False),
    ("debug HRconv 16->64 lrelu", (4, 64, 64, 16), 0, 64, "lrelu", False),
]
EDVRL_CUTS = dict(nf=128, front_RBs=1, back_RBs=1, nframes=5)


def width_inputs(shape, dg, dtype, seed, std=2.5, cout=None):
    """x, offsets (std ``std`` px: taps outside the image, some beyond
    ±8), mask, weight, bias and cotangent at C = shape[-1] channels in,
    ``cout`` (None: C) out, in ``dg`` groups, drawn on the card in f32 and
    cast."""
    import torch

    b, h, w, c = shape
    cout = c if cout is None else cout
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(*size):
        return torch.rand(*size, generator=g, device="cuda")

    def randn(*size):
        return torch.randn(*size, generator=g, device="cuda")

    out = (randn(b, h, w, c), randn(b, h, w, dg * 18) * std,
           rand(b, h, w, dg * 9),
           (rand(cout, c, 3, 3) * 2 - 1) / (9 * c) ** 0.5,
           randn(cout) * 0.1, randn(b, h, w, cout))
    return [t.to(dtype) for t in out]


def hold_dcn_pair(what, shape, dg, dtype, seed, radii=(4, 8, None),
                  cout=None, has_mask=True):
    """Both DCN kernels at (shape, dg) and ``cout`` outputs (None: C), both
    forms (the in-place ``om`` only with a mask), against their plain
    versions with check.py's tolerances; returns {(kernel, form, r): max abs
    err over the outputs}."""
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
    for r in radii:
        x, off, mask, wgt, bias, gout = width_inputs(shape, dg, dtype, seed,
                                                     cout=cout)
        om = om_of(off, mask)
        if not has_mask:
            mask = None
        forms = (
            ("separate",
             lambda: dcn_fwd(x, off, mask, wgt, bias, dg, "lrelu", r),
             lambda: dcn_fwd_plain(x, off, mask, wgt, bias, dg, "lrelu", r),
             lambda: dcn_bwd(x, off, mask, wgt, gout, dg, r),
             lambda: dcn_bwd_plain(x, off, mask, wgt, gout, dg, r),
             ("dx", "doffset", "dmask", "dweight")),
            ("om",
             lambda: dcn_fwd_om(x, om, wgt, bias, dg, "lrelu", r),
             lambda: dcn_fwd_om_plain(x, om, wgt, bias, dg, "lrelu", r),
             lambda: dcn_bwd_om(x, om, wgt, gout, dg, r),
             lambda: dcn_bwd_om_plain(x, om, wgt, gout, dg, r),
             ("dx", "dom", "dweight")))
        for form, fwd, fwd_ref, bwd, bwd_ref, names in forms[
                :2 if has_mask else 1]:
            out = fwd()
            torch.cuda.synchronize()
            ref = fwd_ref()
            row = {"out": dict(max_abs_err=max_abs_err(out, ref),
                               tol=tolerance(ref))}
            ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
                  and row["out"]["max_abs_err"] <= row["out"]["tol"])
            del out, ref
            grads = bwd()
            torch.cuda.synchronize()
            grefs = bwd_ref()
            for name, o, rf in zip(names, grads, grefs):
                if rf is None:   # no mask: no mask gradient
                    ok = ok and o is None
                    continue
                row[name] = dict(max_abs_err=max_abs_err(o, rf),
                                 tol=grad_tolerance(rf))
                ok = ok and (o.shape == rf.shape and o.dtype == rf.dtype
                             and bool(torch.isfinite(o).all())
                             and row[name]["max_abs_err"]
                             <= row[name]["tol"])
            del grads, grefs
            emit(check=what, form=form, shape=shape, groups=dg,
                 cout=wgt.shape[0], mask=has_mask, dtype=str(dtype)[6:],
                 max_offset=r, **row)
            if not ok:
                raise AssertionError(f"{what} {shape} -> {wgt.shape[0]} dg "
                                     f"{dg} mask {has_mask} {form} {dtype} "
                                     f"r={r}: {row}")
            errs[("dcn_fwd", form, r)] = row["out"]["max_abs_err"]
            errs[("dcn_bwd", form, r)] = max(row[n]["max_abs_err"]
                                             for n in names if n in row)
        del x, off, mask, om, gout
        torch.cuda.empty_cache()
    return errs


def check_widths():
    """Phase 3 at the new widths: both DCN kernels at (128, 8) at EDVR-L's
    inference shape and a training sample, and on the narrow kernels at
    NARROW_WIDTHS (the debug shape's pixels), ±4 / ±8 / exact, both forms,
    bf16 and f32; the block API at (128, 8) ±4; EDVR-L's conv widths.
    Returns {key: max abs err}."""
    import torch

    from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
    from realvsr_tpu_torch.ops.deform_conv_block import (
        modulated_deform_conv_block)
    from realvsr_tpu_torch.ops.kernels.check import max_abs_err, tolerance
    from realvsr_tpu_torch.ops.kernels.conv3x3 import (LINE, chunk_bytes,
                                                       conv3x3,
                                                       conv3x3_plain)

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for name, shape in DCN128_SHAPES:
            for k, e in hold_dcn_pair("dcn_c128", shape, 8, dtype,
                                      41).items():
                errs[(*k, name, dname)] = e
        for c, dg in NARROW_WIDTHS:
            for k, e in hold_dcn_pair("dcn_narrow", (*NARROW_SHAPE[:3], c),
                                      dg, dtype, 43).items():
                errs[(*k, f"C{c} dg{dg}", dname)] = e
        x, off, mask, wgt, bias, _ = width_inputs(DCN128_SHAPES[0][1], 8,
                                                  dtype, 45)
        out = modulated_deform_conv_block(x, off, mask, wgt, bias,
                                          deformable_groups=8,
                                          max_offset=R_INFER)
        torch.cuda.synchronize()
        ref = modulated_deform_conv_plain(x, off, mask, wgt, bias, 1, 1, 1, 8,
                                          R_INFER)
        err, tol = max_abs_err(out, ref), tolerance(ref)
        emit(check="dcn_block_c128", dtype=dname, shape=DCN128_SHAPES[0][1],
             max_offset=R_INFER, max_abs_err=err, tol=tol)
        if not err <= tol:
            raise AssertionError(f"block API at 128: {err} > {tol}")
        errs[("dcn_block", "c128", dname)] = err
        del x, off, mask, out, ref
        for name, shape, c2, cout, act, residual in EDVRL_CONVS + SYNC_CASES:
            x, x2, wgt, bs, res = conv_inputs(shape, c2, residual, dtype, 47,
                                              cout)
            out = conv3x3(x, wgt, bs, act, res, x2)
            torch.cuda.synchronize()
            ref = conv3x3_plain(x, wgt, bs, act, res, x2)
            err, tol = max_abs_err(out, ref), tolerance(ref)
            line = chunk_bytes(shape[3], c2, dtype)
            kernel = "conv3x3_fused" if line == LINE else "conv3x3_narrow"
            emit(check=kernel, case=name, dtype=dname, shape=shape,
                 c2=c2, cout=cout, residual=residual, max_abs_err=err,
                 tol=tol, route=f"wgmma, {line}-byte chunks")
            if not (err <= tol and torch.isfinite(out).all()):
                raise AssertionError(f"{name} {dtype}: {err} > {tol}")
            errs[(kernel, name, dname)] = err
            del x, x2, res, out, ref
        torch.cuda.empty_cache()
    return errs


def edvr_l_opt():
    """The x4 + TSA recipe's options with EDVR-L's network_G (nf 128, 40
    back ResBlocks; 8 groups, 5 front ResBlocks, 7 frames as the recipe
    gives them)."""
    opt = network_opt(EDVRX4_CFG)
    opt["network_G"].update(EDVRL_NET)
    return opt


def edvr_l_path(tmp, clip):
    """EDVR-L (bf16, ±4, seeded weights, offset convs randomised) through
    ``evaluate_wo_gt`` on EDVR x4's 7-frame 448x256 clip, the launches per
    window held to EXPECT["edvr_l"]; then the same weights at 32x32 on the
    card (f32, bf16) against the CPU in f32."""
    import torch

    from realvsr_tpu_torch.models import define_g

    opt = edvr_l_opt()
    n, scale = opt["network_G"]["nframes"], opt["scale"]

    def build(dev, dtype=torch.float32):
        return define_g(opt, device=dev, dtype=dtype,
                        generator=torch.Generator().manual_seed(50),
                        dcn_max_offset=R_INFER)

    model = build("cuda", torch.bfloat16)
    randomise_offset_convs(model, seed=51, std=0.7)
    hw = (VIMEO_H, VIMEO_W)
    launches = drive_path("edvr_l", model, clip, n, n,
                          (hw[0] * scale, hw[1] * scale), tmp)
    card_vs_cpu("edvr_l", build, model, (1, n, 32, 32, 3))
    return model, clip, n, hw, launches


def edvr_l_training(tmp, profile=False):
    """EDVR-L through the port's Trainer on the x4 recipe's batch (GT 256²
    x 32, LQ 64², 7 frames; SyntheticMotion data, no cutblur, which raises
    at x4), RECIPE_STEPS steps in f32 and in bf16, offsets randomised,
    launches a step held to EDVRL_STEP; then one Split step at full width
    and cut depth (EDVRL_CUTS, LQ 32x32) card vs CPU."""
    import torch

    out = {}
    torch.backends.cudnn.allow_tf32 = True   # as the recipe runs
    for dtype in ("float32", "bfloat16"):
        opt = _train_opt(os.path.join(tmp, "edvr_l"), dtype, EDVRX4_CFG,
                         mode="SyntheticMotion", steps=RECIPE_STEPS)
        opt["network_G"].update(EDVRL_NET)
        opt["augment"] = None
        warm = warm_motion(opt)
        res = run_trainer(opt, EDVRL_STEP, offsets_seed=11, profile=profile)
        summary = res.pop("profile", None)
        emit(phase="training_recipe", path="edvr_l", config=EDVRX4_CFG,
             network=EDVRL_NET, dtype=dtype, data="SyntheticMotion",
             data_setup_s=warm, augment=None,
             cuts=["SyntheticMotion in place of Vimeo90K (not in the repo)",
                   "no cutblur (raises at x4)", "no validation",
                   f"{RECIPE_STEPS} steps"], **res)
        if summary:
            print(f"--- torch.profiler, training edvr_l {dtype}\n{summary}")
        out[dtype] = res
    torch.backends.cudnn.allow_tf32 = False
    reduced_train_step(EDVRX4_CFG, EDVRL_CUTS, 32, "SyntheticMotion",
                       spread=True)
    return out


def time_widths():
    """Phase 9 at the other widths, bf16 and f32: both DCN kernels at
    (128, 8) (the forward at EDVR-L's L1 inference shape ±4, the backward
    at its L1 training shape ±8) and on the narrow kernels at the debug
    width and NARROW_WIDTHS (the debug shape's pixels, ±8, separate form),
    each beside its plain version and its bound; EDVR-L's conv widths
    beside cuDNN.  Returns {key: row}."""
    import torch
    import torch.nn.functional as F

    from realvsr_tpu_torch.ops.deform_conv import apply_act
    from realvsr_tpu_torch.ops.kernels.conv3x3 import (LINE, chunk_bytes,
                                                       conv3x3,
                                                       conv3x3_plain)
    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_om,
                                                   dcn_bwd_plain, dcn_fwd,
                                                   dcn_fwd_om, dcn_fwd_plain)

    rows, r8 = {}, train_r()
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        # the forward at L1 inference: bytes x, offsets, mask, weight, bias,
        # out; tensor cores 2 p (9 C) C; f32 cores ~9 a sampled element
        shape = DCN128_SHAPES[0][1]
        x, off, mask, wgt, bias, _ = width_inputs(shape, 8, dtype, 53)
        om = om_of(off, mask)
        out = dcn_fwd(x, off, mask, wgt, bias, 8, None, R_INFER)
        p, k = shape[0] * shape[1] * shape[2], 9 * shape[3]
        b_ms, b_by = bound(nbytes(x, off, mask, wgt, bias, out),
                           2 * p * k * 128, 9 * p * k, dname)
        row = dict(
            ms=cuda_ms(lambda: dcn_fwd(x, off, mask, wgt, bias, 8, None,
                                       R_INFER), 20),
            ms_om=cuda_ms(lambda: dcn_fwd_om(x, om, wgt, bias, 8, None,
                                             R_INFER), 20),
            plain_ms=cuda_ms(lambda: dcn_fwd_plain(x, off, mask, wgt, bias,
                                                   8, None, R_INFER), 3,
                             warmup=1),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit(timing="dcn_fwd", case="C128 L1 infer", shape=shape,
             dtype=dname, max_offset=R_INFER, **row)
        rows[("dcn_fwd", "c128", dname)] = row
        del x, off, mask, om, out
        # the backward at L1 training: the plain version over the batch in
        # chunks of 56 frames
        x, off, mask, wgt, _, gout = width_inputs(TRAIN_L1_128, 8, dtype, 55)
        om = om_of(off, mask)
        outs = dcn_bwd(x, off, mask, wgt, gout, 8, r8)
        p = TRAIN_L1_128[0] * TRAIN_L1_128[1] * TRAIN_L1_128[2]
        b_ms, b_by = bound(nbytes(x, off, mask, wgt, gout, *outs),
                           4 * p * k * 128, 20 * p * k, dname)
        del outs

        def plain():
            for i in range(0, x.shape[0], 56):
                dcn_bwd_plain(x[i:i + 56], off[i:i + 56], mask[i:i + 56],
                              wgt, gout[i:i + 56], 8, r8)

        row = dict(
            ms=cuda_ms(lambda: dcn_bwd(x, off, mask, wgt, gout, 8, r8), 5),
            ms_om=cuda_ms(lambda: dcn_bwd_om(x, om, wgt, gout, 8, r8), 5),
            plain_ms=(cuda_ms(plain, 1, warmup=1)
                      if dtype == torch.bfloat16 else None),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        emit(timing="dcn_bwd", case="C128 L1 train", shape=TRAIN_L1_128,
             dtype=dname, max_offset=r8, **row)
        rows[("dcn_bwd", "c128", dname)] = row
        del x, off, mask, om, gout
        torch.cuda.empty_cache()
        # the narrow kernels: forward, the tap products (2 p k C, at the
        # tensor cores' rate for the dtype, the card's best for them,
        # whatever the kernel runs them on) and ~9 f32 ops a sampled
        # element; backward, dS and dW (2 x 2 p k C) and ~20 f32 ops a
        # sampled element with its corners' gradients
        for c, dg in [NARROW] + NARROW_WIDTHS:
            shape = (*NARROW_SHAPE[:3], c)
            x, off, mask, wgt, bias, gout = width_inputs(shape, dg, dtype, 57)
            out = dcn_fwd(x, off, mask, wgt, bias, dg, None, r8)
            grads = dcn_bwd(x, off, mask, wgt, gout, dg, r8)
            p, k = shape[0] * shape[1] * shape[2], 9 * c
            for name, fn, pl, moved, tc_ops, f32_ops in (
                    ("dcn_fwd",
                     lambda: dcn_fwd(x, off, mask, wgt, bias, dg, None, r8),
                     lambda: dcn_fwd_plain(x, off, mask, wgt, bias, dg, None,
                                           r8),
                     nbytes(x, off, mask, wgt, bias, out), 2 * p * k * c,
                     9 * p * k),
                    ("dcn_bwd",
                     lambda: dcn_bwd(x, off, mask, wgt, gout, dg, r8),
                     lambda: dcn_bwd_plain(x, off, mask, wgt, gout, dg, r8),
                     nbytes(x, off, mask, wgt, gout, *grads), 4 * p * k * c,
                     20 * p * k)):
                b_ms, b_by = bound(moved, tc_ops, f32_ops, dname)
                row = dict(ms=cuda_ms(fn, 50), plain_ms=cuda_ms(pl, 3),
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
                if (c, dg) == NARROW:  # the debug width: host-paced calls
                    row["device_ms"] = device_ms(fn, 20)
                emit(timing=name, case=f"narrow C{c} dg{dg}", shape=shape,
                     dtype=dname, max_offset=r8, **row)
                rows[(name, f"C{c} dg{dg}", dname)] = row
            del x, off, mask, gout, out, grads
        for name, shape, c2, cout, act, residual in EDVRL_CONVS + SYNC_CASES:
            x, x2, wgt, bias, res = conv_inputs(shape, c2, residual, dtype,
                                                59, cout)
            out = conv3x3(x, wgt, bias, act, res, x2)
            p = shape[0] * shape[1] * shape[2]
            b_ms, b_by = bound(nbytes(x, x2, wgt, bias, res, out),
                               2 * p * 9 * (shape[3] + c2) * cout, 0, dname)
            xcat = x if x2 is None else torch.cat([x, x2], -1)
            x_nchw = xcat.permute(0, 3, 1, 2)
            w_cl = wgt.contiguous(memory_format=torch.channels_last)
            res_nchw = None if res is None else res.permute(0, 3, 1, 2)

            def library():  # cuDNN conv + separate bias / act / residual
                y = apply_act(F.conv2d(x_nchw, w_cl, bias, padding=1), act)
                return y if res_nchw is None else y + res_nchw

            def kernel_call():
                return conv3x3(x, wgt, bias, act, res, x2)

            line = chunk_bytes(shape[3], c2, dtype)
            narrow = line != LINE
            # narrow convs (~0.05 GFLOP) are launch- and host-paced: more
            # calls a timing, so that a host hiccup weighs less, and their
            # device-only time (the profiler's kernel time) read apart
            iters = 200 if narrow else 10
            torch.backends.cudnn.allow_tf32 = dtype == torch.float32
            library_ms = cuda_ms(library, iters)
            device = (dict(device_ms=device_ms(kernel_call, 20),
                           library_device_ms=device_ms(library, 20))
                      if narrow else {})
            torch.backends.cudnn.allow_tf32 = False
            kernel = "conv3x3_narrow" if narrow else "conv3x3_fused"
            row = dict(
                ms=cuda_ms(kernel_call, iters),
                plain_ms=cuda_ms(
                    lambda: conv3x3_plain(x, wgt, bias, act, res, x2), 3),
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                route=f"wgmma, {line}-byte chunks", **device,
                **streamed_info(shape, c2, cout, dtype, residual))
            add_slice_us(row, shape, c2, dtype)
            emit(timing=kernel, case=name, shape=shape, c2=c2, cout=cout,
                 dtype=dname, **row)
            rows[(kernel, name, dname)] = row
            del x, x2, res, out
        torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# Phase 11: the DCN kernels over the TPU kernel's whole domain (dcn_narrow.cu
# at any cin and cout, with no mask), the general DCN surface, and card runs
# of the paths that had only CPU parity: the Combine wrapper, the bare
# AllPair step, the TOF-GAN recipe and evaluate_wi_gt.

# (cin, cout, deformable groups, mask): cin != cout both ways, with and
# without a mask; 96 in 4 groups; 256 in 8 (the chunked backward); DCNv1 at
# 64 -> 64 in 8 (the general path's DeformConvModule)
GENERAL_DCN = [(64, 32, 8, True), (64, 32, 8, False), (32, 64, 8, True),
               (32, 64, 8, False), (96, 96, 4, True), (256, 256, 8, True),
               (64, 64, 8, False)]
GENERAL_PIXELS = (2, 64, 96)   # the general path's frames: batch, h, w
# timed, beside their plain versions and bounds: 128 -> 64, 256 -> 256 and
# DCNv1 at the flagship's 64 -> 64 in 8 groups (no mask: dcn_narrow.cu)
GENERAL_TIMED = [(128, 64, 8, True), (256, 256, 8, True), (64, 64, 8, False)]
# and DCNv1 64 -> 64 in 8 groups at the flagship's L1 (3, 512, 1024, 64),
# beside the wgmma pair's DCNv2 at the same shape (no plain time: the
# plain op's columns at 1.6M pixels take ~0.3 s a forward, ~1 s a
# backward, and the narrow widths hold it at the debug shape's pixels)
GENERAL_L1 = ("64->64 dg8 v1 L1", 64, 64, 8)
COMBINE_CFG = os.path.join("configs", "train",
                           "train_EDVR_woTSA_RealVSR_YCbCr_Combine.yml")
ALLPAIR_CFG = os.path.join("configs", "train", "train_EDVR_woTSA_Vimeo90K.yml")
TOF_GAN_CFG = os.path.join("configs", "train",
                           "train_TOF-GAN_RealVSR_YCbCr_Split.yml")
WRAPPERS = {  # name: (recipe, train set, cuts)
    "combine": (COMBINE_CFG, "Synthetic",
                ["Synthetic data in place of RealVSR (not in the repo)",
                 "no validation", f"{RECIPE_STEPS} steps"]),
    "allpair": (ALLPAIR_CFG, "SyntheticMotion",
                ["SyntheticMotion in place of Vimeo90K (not in the repo; "
                 "moving frames, as Vimeo90K's)", "no validation",
                 f"{RECIPE_STEPS} steps"]),
}
TOF_GAN_CUTS = ["SyntheticMotion in place of RealVSR (not in the repo; "
                "moving frames for SpyNet's flow)",
                "pretrain_model_G: null (the pretrained TOF is not in the "
                "repo)", "no validation", f"{GAN_STEPS} iterations"]
# evaluate_wi_gt: (test config, frames written at its own size: (h, w),
# sequences, frames a sequence)
WI_GT = {
    "realvsr": (os.path.join("configs", "test",
                             "test_EDVR_woTSA_RealVSR_wi_GT.yml"),
                (H, W), 1, CLIP),
    "synthetic_motion": (os.path.join("configs", "test",
                                      "test_synthetic_motion_wi_GT.yml"),
                         (256, 256), 4, 20),
}
WI_GT_SHORT = (3, 64, 128)       # card-vs-CPU clip: frames, h, w
WI_GT_TOL = dict(psnr=1e-2, ssim=1e-3)   # dB; SSIM


def check_general():
    """Phase 11's kernel checks: ``dcn_narrow.cu`` forward and backward at
    GENERAL_DCN (the general path's pixels, ±4 and exact, both forms where
    there is a mask, bf16 and f32) against their plain versions; then
    ``DeformConvModule`` (DCNv1, 32 -> 48 in 4 groups) at 3x3 / p1 (the
    kernels, against the plain op's autograd on the card) and p0 (the
    plain op, against the CPU in f32 from the same inputs and weight,
    rounded to the dtype first: an offset's rounding moves its sample and
    so its position gradient), forward and input, offset and weight
    gradients.  Returns {key: max abs err}."""
    import torch

    from realvsr_tpu_torch.models.common import DeformConvModule
    from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
    from realvsr_tpu_torch.ops.kernels.check import (grad_tolerance,
                                                     max_abs_err, tolerance)

    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for cin, cout, dg, m in GENERAL_DCN:
            case = f"{cin}->{cout} dg{dg}{'' if m else ' v1'}"
            for k, e in hold_dcn_pair("dcn_general", (*GENERAL_PIXELS, cin),
                                      dg, dtype, 61, radii=(4, None),
                                      cout=cout, has_mask=m).items():
                errs[(*k, case, dname)] = e
        for padding in (1, 0):
            g = torch.Generator().manual_seed(63)
            mod = DeformConvModule(32, 48, 3, padding=padding,
                                   deformable_groups=4)
            mod.reset_parameters(g)
            ho, wo = 64 - 2 * (1 - padding), 96 - 2 * (1 - padding)
            x = torch.randn(2, 64, 96, 32, generator=g).to(dtype).float()
            off = (torch.randn(2, ho, wo, 4 * 18, generator=g) * 2.5).to(
                dtype).float()
            cot = torch.randn(2, ho, wo, 48, generator=g)
            weight = {k: v.to(dtype).float()
                      for k, v in mod.state_dict().items()}

            def run(dev, plain, dt):
                m_ = DeformConvModule(32, 48, 3, padding=padding,
                                      deformable_groups=4).to(dev, dt)
                m_.load_state_dict(weight)
                xs = x.to(dev, dt).requires_grad_()
                os_ = off.to(dev, dt).requires_grad_()
                y = (modulated_deform_conv_plain(
                    xs, os_, None, m_.weight, None, 1, padding, 1, 4)
                    if plain else m_(xs, os_))
                (y.float() * cot.to(dev)).sum().backward()
                return [t.detach().float().cpu()
                        for t in (y, xs.grad, os_.grad, m_.weight.grad)]

            n0 = read_counts()
            got = run("cuda", False, dtype)
            torch.cuda.synchronize()
            n1 = read_counts()
            launched = (n1["dcn_fwd"] - n0["dcn_fwd"],
                        n1["dcn_bwd"] - n0["dcn_bwd"])
            ref = (run("cuda", True, dtype) if padding
                   else run("cpu", False, torch.float32))
            row = {}
            for name, o, r in zip(("out", "dx", "doffset", "dweight"), got,
                                  ref):
                tol = (tolerance(r.to(dtype)) if name == "out"
                       else grad_tolerance(r.to(dtype)))
                row[name] = dict(max_abs_err=max_abs_err(o, r), tol=tol)
            emit(check="deform_conv_module", padding=padding, dtype=dname,
                 form="kernels" if padding else "plain", launches=launched,
                 against="plain autograd on the card" if padding
                 else "the CPU in f32", **row)
            if launched != ((1, 1) if padding else (0, 0)) or any(
                    v["max_abs_err"] > v["tol"] for v in row.values()):
                raise AssertionError(f"DeformConvModule p{padding} {dtype}: "
                                     f"{launched} {row}")
            errs[("deform_conv_module", padding, dname)] = max(
                v["max_abs_err"] for v in row.values())
        torch.cuda.empty_cache()
    return errs


def general_dcn_path():
    """The general DCN surface as a user calls it, on the card, bf16: a
    DCNPack at 64 -> 32 in the PCD-align mode and one at 256 -> 256 (8
    groups) with offsets from x itself, a DeformConvModule (DCNv1, 64 -> 64
    in 8 groups) at p1, each forward and backward (these launch
    dcn_narrow.cu), and a DCNPack at kernel_size 5 and a DeformConvModule
    at p0 (the plain op, no launch), on GENERAL_PIXELS frames; the counts
    set to 0 just before and read just after, held to 3 forward and 3
    backward launches (and the two 3x3 offset convs on the conv3x3 kernel
    at 216 outputs).  Then each of the three kernel modules' outputs and
    gradients (input, offsets, parameters) against the plain op on the same
    card inputs and cotangents (its DCN swapped for
    ``modulated_deform_conv_plain``, the offset conv the same), within
    check.py's tolerances."""
    import torch

    from realvsr_tpu_torch.models.common import (DCNPack, DeformConvModule,
                                                 reset_parameters)
    from realvsr_tpu_torch.ops.deform_conv import (modulated_deform_conv_plain,
                                                   split_om)
    from realvsr_tpu_torch.ops.kernels.check import (grad_tolerance,
                                                     max_abs_err, tolerance)

    g = torch.Generator().manual_seed(65)
    bf = torch.bfloat16
    mods = [DCNPack(64, 32, 8), DCNPack(256, 256, 8, extra_offset_mask=False),
            DeformConvModule(64, 64, 3, padding=1, deformable_groups=8),
            DCNPack(64, 64, 8, kernel_size=5, padding=2,
                    extra_offset_mask=False),
            DeformConvModule(64, 64, 3, padding=0, deformable_groups=8)]
    for m in mods:
        reset_parameters(torch.nn.Sequential(m), g)
        m.to("cuda", bf)
        if isinstance(m, DCNPack):   # offsets of a few pixels
            randomise_offset_convs(m, seed=66, std=0.1)
    b, h, w = GENERAL_PIXELS
    x64 = torch.randn(b, h, w, 64, generator=g).to("cuda", bf)
    x256 = torch.randn(b, h, w, 256, generator=g).to("cuda", bf)
    off1 = (torch.randn(b, h, w, 8 * 18, generator=g) * 2).to("cuda", bf)
    off0 = (torch.randn(b, h - 2, w - 2, 8 * 18, generator=g) * 2).to(
        "cuda", bf)
    # (module, its inputs, act); the first three run the kernels
    calls = [(mods[0], (x64, x64), "lrelu"), (mods[1], (x256,), None),
             (mods[2], (x64, off1), None), (mods[3], (x64,), None),
             (mods[4], (x64, off0), None)]
    cots = [torch.randn(b, h - 2 * (i == 4), w - 2 * (i == 4),
                        m.weight.shape[0], generator=g).to("cuda")
            for i, (m, _, _) in enumerate(calls)]

    def run(forward):
        """Each call's output and gradients (inputs, then parameters) for
        ``forward(module, leaves, act)``, from fresh input leaves."""
        for m in mods:
            m.zero_grad(set_to_none=True)
        res = []
        for (m, ins, act), cot in zip(calls, cots):
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            y = forward(m, leaves, act)
            (y.float() * cot).sum().backward()
            res.append([y.detach()] + [t.grad for t in leaves]
                       + [p.grad for p in m.parameters()])
        return res

    def kernels(m, leaves, act):
        return m(*leaves, act=act) if isinstance(m, DCNPack) else m(*leaves)

    def plain(m, leaves, act):
        if isinstance(m, DeformConvModule):
            return modulated_deform_conv_plain(
                leaves[0], leaves[1], None, m.weight.to(bf), None, m.stride,
                m.padding, m.dilation, m.deformable_groups, groups=m.groups)
        om = m.conv_offset_mask(leaves[-1])
        return modulated_deform_conv_plain(
            leaves[0], *split_om(om, m.deformable_groups), m.weight.to(bf),
            m.bias.to(bf), m.stride, m.padding, m.dilation,
            m.deformable_groups, m.max_offset, act, m.groups)

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.time()
    got = run(kernels)
    torch.cuda.synchronize()
    launches = read_counts()
    seconds = time.time() - t0
    want = {"dcn_fwd": 3, "dcn_bwd": 3, "conv3x3": 0, "conv3x3_fused": 2,
            "dcn_block": 0, "conv3x3_narrow": 0}
    shapes = [list(r[0].shape) for r in got]
    finite = all(t is not None and bool(torch.isfinite(t).all())
                 for r in got for t in r)
    ref = run(plain)
    held = {}
    for label, (m, ins, _), o, r in zip(
            ("dcnpack_64_32", "dcnpack_256", "deform_conv_p1"), calls, got,
            ref):
        names = (["out"] + [f"d_input{k}" for k in range(len(ins))]
                 + [f"d_{n}" for n, _ in m.named_parameters()])
        for name, a, e in zip(names, o, r):
            tol = tolerance(e) if name == "out" else grad_tolerance(e)
            held[f"{label}.{name}"] = dict(max_abs_err=max_abs_err(a, e),
                                           tol=tol)
    emit(phase="path", path="general_dcn", launches=launches, expected=want,
         shapes=shapes, seconds=seconds, against_plain=held)
    if launches != want or not finite or any(
            v["max_abs_err"] > v["tol"] for v in held.values()):
        raise AssertionError(f"general DCN path: {launches} vs {want}, "
                             f"finite {finite}, {held}")
    return launches


def time_general():
    """Phase 9 at GENERAL_TIMED, bf16 and f32: ``dcn_narrow.cu`` forward
    (±4) and backward (±8) at the debug shape's pixels, beside the plain
    versions and the bounds (as the narrow widths: the tap products at the
    tensor cores' rate for the dtype, ~9 f32 operations a sampled element
    forward, ~20 backward); then GENERAL_L1, DCNv1 64 -> 64 in 8 groups at
    the flagship's L1, beside the wgmma pair's DCNv2 on the same inputs
    (no plain time).  Returns {key: row}."""
    import torch

    from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_plain,
                                                   dcn_fwd, dcn_fwd_plain)

    rows, r8 = {}, train_r()
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for cin, cout, dg, m in GENERAL_TIMED:
            shape = (*NARROW_SHAPE[:3], cin)
            x, off, mask, wgt, bias, gout = width_inputs(shape, dg, dtype, 67,
                                                         cout=cout)
            mask = mask if m else None
            out = dcn_fwd(x, off, mask, wgt, bias, dg, None, R_INFER)
            grads = dcn_bwd(x, off, mask, wgt, gout, dg, r8)
            p, k = shape[0] * shape[1] * shape[2], 9 * cin
            case = f"{cin}->{cout} dg{dg}{'' if m else ' v1'}"
            for name, fn, pl, moved, tc_ops, f32_ops in (
                    ("dcn_fwd",
                     lambda: dcn_fwd(x, off, mask, wgt, bias, dg, None,
                                     R_INFER),
                     lambda: dcn_fwd_plain(x, off, mask, wgt, bias, dg, None,
                                           R_INFER),
                     nbytes(x, off, mask, wgt, bias, out), 2 * p * k * cout,
                     9 * p * k),
                    ("dcn_bwd",
                     lambda: dcn_bwd(x, off, mask, wgt, gout, dg, r8),
                     lambda: dcn_bwd_plain(x, off, mask, wgt, gout, dg, r8),
                     nbytes(x, off, mask, wgt, gout, *grads),
                     4 * p * k * cout, 20 * p * k)):
                b_ms, b_by = bound(moved, tc_ops, f32_ops, dname)
                row = dict(ms=cuda_ms(fn, 20), plain_ms=cuda_ms(pl, 3),
                           bound_ms=b_ms, bound_by=b_by, library_ms=None)
                emit(timing=name, case=f"general {case}", shape=shape,
                     cout=cout, mask=m, dtype=dname,
                     max_offset=R_INFER if name == "dcn_fwd" else r8, **row)
                rows[(name, case, dname)] = row
            del x, off, mask, gout, out, grads
        torch.cuda.empty_cache()
        # DCNv1 64 -> 64 in 8 groups at the flagship's L1 (dcn_narrow.cu),
        # beside the wgmma pair on the same inputs with a mask (DCNv2)
        case, cin, cout, dg = GENERAL_L1
        shape = DCN_CASES[0][1]
        x, off, mask, wgt, bias, gout = width_inputs(shape, dg, dtype, 71,
                                                     cout=cout)
        out = dcn_fwd(x, off, None, wgt, bias, dg, None, R_INFER)
        grads = dcn_bwd(x, off, None, wgt, gout, dg, r8)
        p, k = shape[0] * shape[1] * shape[2], 9 * cin
        for name, fn, pair, moved, tc_ops, f32_ops in (
                ("dcn_fwd",
                 lambda: dcn_fwd(x, off, None, wgt, bias, dg, None, R_INFER),
                 lambda: dcn_fwd(x, off, mask, wgt, bias, dg, None, R_INFER),
                 nbytes(x, off, wgt, bias, out), 2 * p * k * cout,
                 9 * p * k),
                ("dcn_bwd",
                 lambda: dcn_bwd(x, off, None, wgt, gout, dg, r8),
                 lambda: dcn_bwd(x, off, mask, wgt, gout, dg, r8),
                 nbytes(x, off, wgt, gout, *grads), 4 * p * k * cout,
                 20 * p * k)):
            b_ms, b_by = bound(moved, tc_ops, f32_ops, dname)
            row = dict(ms=cuda_ms(fn, 5), plain_ms=None, bound_ms=b_ms,
                       bound_by=b_by, library_ms=None,
                       wgmma_pair_dcnv2_ms=cuda_ms(pair, 5))
            emit(timing=name, case=f"general {case}", shape=shape, cout=cout,
                 mask=False, dtype=dname,
                 max_offset=R_INFER if name == "dcn_fwd" else r8, **row)
            rows[(name, case, dname)] = row
        del x, off, mask, gout, out, grads
        torch.cuda.empty_cache()
    return rows


def wrapper_training(tmp, profile=False):
    """The Combine wrapper (``make_combine_train_step``) and the bare
    ``VideoSR_AllPair`` step through ``make_train_step``'s dispatch: one
    step of each recipe's network (EDVR_NoUp, full width and depth) at 64x64
    card vs CPU (``reduced_train_step``), then the recipe's network and
    batch (192² x 32, 3 frames, its cutblur on) through the port's Trainer,
    f32 (TF32) and bf16, ±8, offsets randomised, RECIPE_STEPS steps, with
    the flagship's launches a step.  Returns {(name, dtype): result}."""
    import torch

    per_step = dict(EXPECT["edvr_noup"], dcn_bwd=4, dcn_block=0)
    out = {}
    for name, (recipe, mode, cuts) in WRAPPERS.items():
        reduced_train_step(recipe, None, 64, mode)
        torch.backends.cudnn.allow_tf32 = True
        for dtype in ("float32", "bfloat16"):
            opt = _train_opt(tmp, dtype, recipe, mode=mode,
                             steps=RECIPE_STEPS)
            warm = warm_motion(opt)
            res = run_trainer(opt, per_step, offsets_seed=11,
                              profile=profile)
            summary = res.pop("profile", None)
            emit(phase="training_recipe", path=name, config=recipe,
                 model=opt["model"], dtype=dtype, data=mode,
                 data_setup_s=warm, augment=opt["augment"], cuts=cuts, **res)
            if summary:
                print(f"--- torch.profiler, training {name} {dtype}\n"
                      f"{summary}")
            out[(name, dtype)] = res
        torch.backends.cudnn.allow_tf32 = False
    return out


def tof_gan_training(tmp, profile=False):
    """``train_TOF-GAN_RealVSR_YCbCr_Split.yml``: the GAN step with
    SpyNet's BatchNorm in G.  One step at 64x64 card vs CPU
    (``reduced_gan_step``: G's and D's gradients and both models' running
    statistics), then the recipe's G (TOF, nf 64, 10 blocks) and D
    (MultiscaleDiscriminator_v4, 2 PatchGANs on the Y pyramid, ragan) at
    its 192² x 32 batch through the port's Trainer, f32 (TF32) and bf16,
    GAN_STEPS steps (cuts TOF_GAN_CUTS), TOF's launches a step (D runs no
    kernel), G never gated off."""
    import torch

    reduced_gan_step(cfg=TOF_GAN_CFG, mode="SyntheticMotion")
    out = {}
    torch.backends.cudnn.allow_tf32 = True
    for dtype in ("float32", "bfloat16"):
        opt = _train_opt(tmp, dtype, TOF_GAN_CFG, mode="SyntheticMotion",
                         steps=GAN_STEPS)
        opt["path"]["pretrain_model_G"] = None
        warm = warm_motion(opt)
        res = run_trainer(opt, GEN_STEP["tof"], profile=profile)
        summary = res.pop("profile", None)
        emit(phase="training_gan", config=TOF_GAN_CFG, dtype=dtype,
             data="SyntheticMotion", data_setup_s=warm, cuts=TOF_GAN_CUTS,
             augment=opt["augment"], **res)
        if summary:
            print(f"--- torch.profiler, training TOF-GAN {dtype}\n{summary}")
        if any(s["g_active"] != 1.0 for s in res["losses"]):
            raise AssertionError("a TOF-GAN step gated G off")
        out[dtype] = res
    torch.backends.cudnn.allow_tf32 = False
    return out


def _write_pairs(root, name, seqs, frames, h, w, seed):
    """GT and LQ sequences (``<root>/{GT,LQ}/<seq>/%05d.png``) at h x w:
    smooth texture moving 3 px a frame, and its LQ blurred and noisy; for
    the motion config the port's ``dump_synthetic_testset`` at its own
    frames (moving shapes, realistic degradation)."""
    import cv2
    import numpy as np

    if name == "synthetic_motion":
        from realvsr_tpu_torch.tools.dump_synthetic_testset import dump

        dump(root, num_seqs=seqs, frames=frames, height=h, width=w)
        return
    rng = np.random.default_rng(seed)
    for s in range(seqs):
        base = cv2.resize(rng.random((h // 8, w // 8 + 8, 3)).astype(
            np.float32), (w + 3 * frames + 8, h),
            interpolation=cv2.INTER_CUBIC)
        for part in ("GT", "LQ"):
            os.makedirs(os.path.join(root, part, f"{s:03d}"))
        for t in range(frames):
            gt = base[:, 3 * t:3 * t + w]
            lq = cv2.GaussianBlur(gt, (5, 5), 1.2) + rng.normal(
                size=gt.shape).astype(np.float32) * 0.02
            for part, img in (("GT", gt), ("LQ", lq)):
                cv2.imwrite(os.path.join(root, part, f"{s:03d}",
                                         f"{t:05d}.png"),
                            (np.clip(img, 0, 1) * 255).round().astype(
                                np.uint8))


def wi_gt_phase(tmp):
    """``eval/test_wi_gt.py`` through ``tools/test_wi_gt.py`` (its
    ``main``, as the command line runs it) for each WI_GT config: the
    config's network (EDVR_NoUp, nf 64, 5 + 10 blocks) with seeded weights
    (offset convs randomised) saved as its ``pretrain_model_G``, on frames
    written at the config's own size, on the card in bf16 with the
    deployment clamp (timed, launches per window held to the flagship's),
    then on a short clip (WI_GT_SHORT) on the card and on the CPU in f32:
    the reported PSNR and SSIM within WI_GT_TOL.  Returns {name:
    launches}."""
    import torch
    import yaml

    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.tools.test_wi_gt import main as test_wi_gt

    out = {}
    for i, (name, (cfg, (h, w), seqs, frames)) in enumerate(WI_GT.items()):
        opt = network_opt(cfg)
        model = define_g(opt, device="cpu",
                         generator=torch.Generator().manual_seed(70 + i))
        randomise_offset_convs(model, seed=71 + i, std=0.5)
        weights = os.path.join(tmp, f"wi_gt_{name}.pth")
        torch.save(model.state_dict(), weights)
        del model

        def run(root, device, dtype, tag, max_offset=None):
            o = dict(opt, name=f"chip_smoke_wi_gt_{name}_{tag}")
            o["datasets"] = {"test": dict(
                opt["datasets"]["test"], dataroot_LQ=os.path.join(root, "LQ"),
                dataroot_GT=os.path.join(root, "GT"))}
            o["path"] = dict(opt["path"], pretrain_model_G=weights)
            path = os.path.join(tmp, f"wi_gt_{name}_{tag}.yml")
            with open(path, "w") as f:
                yaml.safe_dump(o, f)
            argv = ["-opt", path, "--device", device, "--dtype", dtype]
            if max_offset is not None:
                argv += ["--max_offset", str(max_offset)]
            return test_wi_gt(argv)

        full = os.path.join(tmp, f"wi_gt_{name}")
        _write_pairs(full, name, seqs, frames, h, w, seed=72 + i)
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.time()
        res = run(full, "cuda", "bfloat16", "full", R_INFER)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        launches = read_counts()
        windows = seqs * frames
        want = {k: v * windows for k, v in EXPECT["edvr_noup"].items()}
        want.update(dcn_bwd=0, dcn_block=0)
        short = os.path.join(tmp, f"wi_gt_{name}_short")
        t, sh, sw = WI_GT_SHORT
        _write_pairs(short, name, 1, t, sh, sw, seed=73 + i)
        card = run(short, "cuda", "float32", "short_card")
        cpu = run(short, "cpu", "float32", "short_cpu")
        err = {k: abs(card[k] - cpu[k]) for k in ("psnr", "ssim")}
        emit(phase="evaluate_wi_gt", config=cfg, frames=[seqs, frames, h, w],
             dtype="bfloat16", max_offset=R_INFER, result=res,
             seconds=seconds, frames_per_s=windows / seconds,
             launches=launches, expected=want, short_clip=WI_GT_SHORT,
             short_card=card, short_cpu=cpu, short_err=err, tol=WI_GT_TOL,
             weights="seeded, offset convs std 0.5 (not the trained model)")
        if not (launches == want and all(math.isfinite(v) for v in
                                         res.values())
                and all(err[k] <= WI_GT_TOL[k] for k in err)):
            raise AssertionError(f"evaluate_wi_gt {name}: {launches} vs "
                                 f"{want}, card {card} cpu {cpu}")
        out[f"wi_gt_{name}"] = launches
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


# --------------------------------------------------------------------------
# Phase 10: multi-process training, the H-sharded forward, the clamp check
# and the degradation.  Ranks are this script started again with
# ``--worker <args.json>`` under torchrun's environment.

DP_STEPS = 6      # each data-parallel run's steps a precision (phase 5: 10)
DP_GLOBAL = 32    # the fixed step's global batch at the recipe's 192²
DP_TOL = 5e-2     # phase 5's card tolerance, of each gradient's largest
GAN_DP = (4, 64)  # the two-rank GAN step's global batch and side
GAN_DP_TOL = 1e-2
CLAMP_RADII = (4, 8)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(tmp, args, world, backend):
    """``world`` ranks of ``--worker`` (:func:`worker_dp`), torchrun's
    environment on a free port; returns each rank's result.  A rank that
    fails (or a run past 600 s) fails the phase, and every rank is
    stopped."""
    path = os.path.join(tmp, f"ranks_{world}.json")
    with open(path, "w") as f:
        json.dump(dict(args, backend=backend), f)
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", path],
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} of {world} exited "
                                 f"{p.returncode}:\n{log[-6000:]}")
    out = []
    for r in range(world):
        with open(f"{path}.{r}.out.json") as f:
            out.append(json.load(f))
    return out


def dp_global_batch():
    """The fixed global batch: Synthetic items 0..31 at the recipe's 192²,
    each from its own seed (the same in every process)."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset

    ds = SyntheticVSRDataset(dict(N_frames=NFRAMES, GT_size=192))
    items = [ds.get(i, np.random.default_rng(i)) for i in range(DP_GLOBAL)]
    return {k: torch.from_numpy(np.stack([it[k] for it in items]))
            for k in ("LQs", "GT")}


def fixed_split_step(tmp, backend=None):
    """One step of the flagship recipe through its Trainer (f32, offsets
    randomised as phase 5's, the recipe's cutblur drawn from the trainer's
    generator) on this rank's rows of :func:`dp_global_batch`; returns G's
    gradients (averaged over the ranks) and parameters after the step, and
    the step's launches."""
    import torch

    from realvsr_tpu_torch.parallel import mesh
    from realvsr_tpu_torch.train.trainer import Trainer

    opt = _train_opt(os.path.join(tmp, "fixed"), "float32")
    trainer = Trainer(opt, device="cuda", dcn_max_offset=train_r(),
                      backend=backend)
    randomise_offset_convs(trainer.model, seed=11, std=0.5)
    batch = mesh.shard_batch(dp_global_batch())
    zero_counts()
    trainer.train_step(trainer.state, {k: v.cuda() for k, v in batch.items()},
                       trainer.gen)
    torch.cuda.synchronize()
    launches = read_counts()
    out = ({k: p.grad.float().cpu() for k, p in
            trainer.model.named_parameters()},
           {k: p.detach().float().cpu() for k, p in
            trainer.model.named_parameters()}, launches)
    del trainer
    torch.cuda.empty_cache()
    return out


def hold_grads(what, got, ref, params=None, ref_params=None, lr=None,
               tol=DP_TOL, model_top=False):
    """Each gradient within ``tol`` of its largest magnitude (with
    ``model_top``, a BN-fed bias or D's output bias, whose gradient is
    rounding or a near-cancelling sum, against its model's largest); the
    parameters after one Adam step within 2 LR (a sign flip of a small
    gradient).  Emits the worst."""
    tops = {}
    for k, v in ref.items():
        m = k.split(".")[0]
        tops[m] = max(tops.get(m, 0.0), v.abs().max().item())
    errs = []
    for k, v in ref.items():
        own = v.abs().max().clamp_min(1e-30).item()
        top = (tops[k.split(".")[0]] if model_top and (
            bn_fed(k, ref) or k.endswith("conv_out.bias")) else own)
        errs.append(((got[k] - v).abs().max().item() / top, k))
    errs.sort()
    info = {}
    if params is not None:
        diff = max((params[k] - v).abs().max().item()
                   for k, v in ref_params.items())
        flips = sum(int(((params[k] - v).abs() > lr / 10).sum())
                    for k, v in ref_params.items())
        info = dict(param_max_abs_diff=diff, param_tol=2 * lr,
                    elements_beyond_lr_over_10=flips,
                    elements=sum(v.numel() for v in ref_params.values()))
    emit(check=what, worst_grad_rel_err=errs[-1][0], worst=errs[-1][1],
         worst_3=errs[-3:], tol=tol, compared=len(errs), **info)
    if errs[-1][0] > tol or (params is not None and diff > 2.0001 * lr):
        raise AssertionError(f"{what}: {errs[-1]}, {info}")


def gan_dp_inputs(tmp):
    """G (the GAN recipe's, full width and depth, offsets randomised) and D
    (nf 64) weights and a Synthetic global batch, saved for the ranks."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset
    from realvsr_tpu_torch.models import define_d, define_g

    opt = network_opt(GAN_CFG)
    g = define_g(opt, device="cpu", dcn_max_offset=train_r(),
                 generator=torch.Generator().manual_seed(12))
    randomise_offset_convs(g, seed=13, std=0.5)
    d = define_d(opt, device="cpu",
                 generator=torch.Generator().manual_seed(14))
    n, side = GAN_DP
    ds = SyntheticVSRDataset(dict(N_frames=3, GT_size=side))
    items = [ds.get(i, np.random.default_rng(i)) for i in range(n)]
    path = os.path.join(tmp, "gan_dp.pt")
    torch.save({"G": g.state_dict(), "D": d.state_dict(),
                "batch": {k: torch.from_numpy(np.stack([it[k] for it in
                                                        items]))
                          for k in ("LQs", "GT")}}, path)
    return path


def gan_dp_step(path):
    """One GAN-Split step (``ragan``, D's BatchNorms; augmentation off) of
    the saved G, D and batch on the card, this rank's rows; returns
    {gradients of G and D, D's running statistics} on the host and the
    step's launches."""
    import torch

    from realvsr_tpu_torch.models import define_d, define_g
    from realvsr_tpu_torch.parallel import mesh
    from realvsr_tpu_torch.train.gan import (create_gan_train_state,
                                             make_gan_split_train_step)

    opt = network_opt(GAN_CFG)
    opt["augment"] = None
    saved = torch.load(path, weights_only=True)
    g = define_g(opt, device="cuda", dcn_max_offset=train_r())
    g.load_state_dict(saved["G"])
    d = define_d(opt, device="cuda")
    d.load_state_dict(saved["D"])
    batch = mesh.shard_batch(saved["batch"])
    zero_counts()
    make_gan_split_train_step(g, opt)(
        create_gan_train_state(g, d, opt),
        {k: v.cuda() for k, v in batch.items()}, torch.Generator("cuda"))
    torch.cuda.synchronize()
    launches = read_counts()
    vals = {f"G.{k}": p.grad for k, p in g.named_parameters()}
    vals.update({f"D.{k}": p.grad for k, p in d.named_parameters()})
    vals.update({f"D.{k}": t for k, t in d.named_buffers() if "running" in k})
    return {k: v.float().cpu() for k, v in vals.items()}, launches


def flagship_inputs(tmp, paths):
    """The inference phase's flagship weights and phase 6's 1920x1088
    window (bf16), saved for the ranks."""
    import torch

    model, _, n, _, _ = paths["edvr_noup"]
    window = read_window(os.path.join(tmp, f"LQ_{HD[1]}x{HD[0]}_{n}"), n)
    path = os.path.join(tmp, "sharded.pt")
    torch.save({"G": model.state_dict(), "window": window.cpu()}, path)
    return path


def flagship(state_dict, max_offset=R_INFER, dtype=None):
    """The flagship EDVR_NoUp on the card (bf16 unless ``dtype``) with these
    weights, clamped to ±``max_offset`` (None: exact), in eval mode."""
    import torch

    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    model = EDVRNoUp(nf=64, nc=3, nframes=NFRAMES, groups=8, front_RBs=5,
                     back_RBs=10, w_TSA=False, dcn_max_offset=max_offset,
                     device="cuda", dtype=dtype or torch.bfloat16)
    model.load_state_dict(state_dict)
    return model.eval()


def worker_dp(args):
    """Ranks of 10a / 10b: the fixed step, then the recipe's Trainer in
    each precision for DP_STEPS steps (launches a step held to phase 5's,
    as run_trainer holds them); then, where asked (the two gloo ranks,
    which run 10c and 10d too, so that one start of the ranks serves
    three phases), the GAN step and the sharded forward."""
    import torch

    from realvsr_tpu_torch.parallel import mesh

    out = {"rank": mesh.rank(), "world": mesh.world_size()}
    grads, params, out["fixed_launches"] = fixed_split_step(
        args["tmp"], args["backend"])
    if mesh.rank() == 0:
        torch.save({"grads": grads, "params": params}, args["fixed_out"])
    torch.backends.cudnn.allow_tf32 = True   # as phase 5's runs
    for dtype in args["dtypes"]:
        opt = _train_opt(os.path.join(args["tmp"], "run"), dtype,
                         steps=DP_STEPS)
        out[dtype] = run_trainer(opt, args["per_step"], offsets_seed=11,
                                 backend=args["backend"])
    torch.backends.cudnn.allow_tf32 = False
    if "gan" in args:
        out["gan"] = worker_gan(args["gan"])
    if "sharded" in args:
        out["sharded"] = worker_sharded(args["sharded"])
    return out


def worker_gan(args):
    from realvsr_tpu_torch.parallel import mesh

    vals, launches = gan_dp_step(args["path"])
    if mesh.rank() == 0:
        import torch

        torch.save(vals, args["out"])
    return {"rank": mesh.rank(), "launches": launches}


def worker_sharded(args):
    """Ranks of 10d: spatial_sharded_forward of the flagship (default halo)
    on the card; launches of one call, its time, rank 0's output saved."""
    import torch

    from realvsr_tpu_torch.eval.spatial import (default_halo,
                                                spatial_sharded_forward)
    from realvsr_tpu_torch.parallel import mesh

    saved = torch.load(args["path"], weights_only=True)
    model = flagship(saved["G"])
    window = saved["window"].cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        zero_counts()
        y = spatial_sharded_forward(model, window)
        torch.cuda.synchronize()
        launches = read_counts()
        ms = cuda_ms(lambda: spatial_sharded_forward(model, window), 3,
                     warmup=1)
    if mesh.rank() == 0:
        torch.save(y.float().cpu(), args["out"])
    return {"rank": mesh.rank(), "launches": launches, "ms": ms,
            "halo": default_halo(model), "shape": list(y.shape),
            "peak_mem_gib": peak_gib()}


CLAMP_STD = 3.0   # the clamp check's offset-conv weights: offsets past ±8


def worker(path) -> int:
    """One rank of a phase-10 run (``--worker <args.json>``): joins the
    process group of torchrun's environment, runs :func:`worker_dp` and
    writes its result to ``<path>.<rank>.out.json``."""
    import torch

    sys.path.insert(0, ROOT)
    from realvsr_tpu_torch.parallel import mesh

    with open(path) as f:
        args = json.load(f)
    mesh.maybe_initialize_distributed("cuda", args["backend"])
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = worker_dp(args)
        with open(f"{path}.{mesh.rank()}.out.json", "w") as f:
            json.dump(out, f)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def parallel_phase(tmp, train, paths, full_1080p_ms):
    """Phase 10 (module docstring); returns each path's launches."""
    import torch

    launches = {}
    per_step = {"dcn_fwd": 4, "dcn_bwd": 4, **EXPECT["edvr_noup"],
                "dcn_block": 0}
    lr = float(network_opt(RECIPE)["train"]["lr_G"])
    torch.cuda.empty_cache()
    # the single-process reference of the fixed step
    ref_grads, ref_params, ref_launches = fixed_split_step(tmp)
    if ref_launches != per_step:
        raise AssertionError(f"fixed step launches {ref_launches}")
    torch.cuda.empty_cache()

    # (a) one rank over NCCL, (b) two ranks over gloo on the one card,
    # which then run (c) and (d) as well
    gan_path, shard_path = gan_dp_inputs(tmp), flagship_inputs(tmp, paths)
    extra = {"gan": dict(path=gan_path, out=os.path.join(tmp, "gan_2.pt")),
             "sharded": dict(path=shard_path,
                             out=os.path.join(tmp, "sharded_2.pt"))}
    fixed = {}
    for key, world, backend in (("nccl_1rank", 1, "nccl"),
                                ("gloo_2rank", 2, "gloo")):
        out = os.path.join(tmp, f"fixed_{key}.pt")
        t0 = time.time()
        ranks = spawn(tmp, dict(
            tmp=os.path.join(tmp, key), dtypes=["float32", "bfloat16"],
            per_step=per_step, fixed_out=out, **(extra if world == 2
                                                  else {})), world, backend)
        fixed[key] = torch.load(out, weights_only=True)
        for dtype in ("float32", "bfloat16"):
            res = [r[dtype] for r in ranks]
            digests = {r["params_sha256"] for r in res}
            emit(phase="training_data_parallel", backend=backend,
                 world=world, dtype=dtype, per_rank_batch=32 // world,
                 steps=DP_STEPS, cuts="DP_STEPS steps (phase 5: 10)",
                 steps_per_s=[r["steps_per_s"] for r in res],
                 median_step_ms=[r["median_step_ms"] for r in res],
                 idle_share=[r["idle_share"] for r in res],
                 peak_mem_gib=[r["peak_mem_gib"] for r in res],
                 launches_per_step=res[0]["launches_per_step"],
                 launches=[r["launches"] for r in res],
                 params_bit_identical=len(digests) == 1,
                 single_process_steps_per_s=train[dtype]["steps_per_s"],
                 single_process_peak_mem_gib=train[dtype]["peak_mem_gib"],
                 wall_s=time.time() - t0)
            if len(digests) != 1:
                raise AssertionError(f"{key} {dtype}: ranks' parameters "
                                     "differ")
            for r, rr in enumerate(res):
                launches[f"dp_{key}_rank{r}_{dtype}"] = rr["launches"]
        for r in ranks:
            if r["fixed_launches"] != per_step:
                raise AssertionError(f"{key} fixed step launches "
                                     f"{r['fixed_launches']}")
    hold_grads("dp_nccl_1rank_fixed_step_vs_single_process",
               fixed["nccl_1rank"]["grads"], ref_grads,
               fixed["nccl_1rank"]["params"], ref_params, lr)
    hold_grads("dp_gloo_2rank_fixed_step_vs_nccl_1rank",
               fixed["gloo_2rank"]["grads"], fixed["nccl_1rank"]["grads"],
               fixed["gloo_2rank"]["params"], fixed["nccl_1rank"]["params"],
               lr)
    del ref_grads, ref_params, fixed

    # (c) the two-rank GAN step against the one-rank step
    one, one_launches = gan_dp_step(gan_path)
    hold_grads("gan_gloo_2rank_step_vs_one_rank",
               torch.load(extra["gan"]["out"]), one, tol=GAN_DP_TOL,
               model_top=True)
    gan = [r["gan"] for r in ranks]
    for r, rr in enumerate(gan):
        launches[f"gan_gloo_2rank_rank{r}"] = rr["launches"]
    if any(rr["launches"] != one_launches for rr in gan):
        raise AssertionError(f"GAN step launches {gan} vs {one_launches}")

    # (d) the H-sharded 1080p forward: two gloo ranks, then 4 shards here
    from realvsr_tpu_torch.eval.spatial import default_halo, shard_forward

    saved = torch.load(shard_path, weights_only=True)
    model = flagship(saved["G"])
    window = saved["window"].cuda()
    with torch.inference_mode():
        full = model(window).float().cpu()
    expect = dict(EXPECT["edvr_noup"], dcn_bwd=0, dcn_block=0)
    out = extra["sharded"]["out"]
    ranks = [r["sharded"] for r in ranks]
    for r, rr in enumerate(ranks):
        launches[f"sharded_1080p_gloo_2rank_rank{r}"] = rr["launches"]
        if rr["launches"] != expect:
            raise AssertionError(f"sharded rank {r}: {rr['launches']}")
    hold_close("sharded_1080p_2rank_vs_full_frame", torch.load(out), full,
               halo=ranks[0]["halo"], window_rows=HD[0] // 2
               + 2 * ranks[0]["halo"])
    halo = default_halo(model)
    parts, shard_launches = [], []
    with torch.inference_mode():
        for i in range(4):
            zero_counts()
            parts.append(shard_forward(model, window, i, 4, halo)
                         .float().cpu())
            torch.cuda.synchronize()
            shard_launches.append(read_counts())
        ms4 = cuda_ms(lambda: [shard_forward(model, window, i, 4, halo)
                               for i in range(4)], 3, warmup=1)
    if any(c != expect for c in shard_launches):
        raise AssertionError(f"4 shards: launches {shard_launches}")
    launches["sharded_1080p_4shard"] = {
        k: sum(c[k] for c in shard_launches) for k in expect}
    hold_close("sharded_1080p_4shard_vs_full_frame", torch.cat(parts, 1),
               full, halo=halo)
    emit(timing="sharded_1080p", dtype="bfloat16", halo=halo,
         gloo_2rank_ms_per_frame=[r["ms"] for r in ranks],
         gloo_2rank_peak_mem_gib=[r["peak_mem_gib"] for r in ranks],
         four_shards_one_process_ms_per_frame=ms4,
         full_frame_ms_per_frame=full_1080p_ms,
         launches_per_shard=expect)
    del model, window, full, parts

    # (e) the clamp check and the SRMD degradation
    launches["clamp_check"] = clamp_check(paths)
    srmd_check()
    return launches


def clamp_check(paths):
    """``tools/validate_dcn_clamp.validate`` of the flagship's weights (the
    exact model, f32, its offset convs drawn with std CLAMP_STD so that
    offsets pass the clamps; phase 4's reach ~4 px) on the 1024x512 clip's
    first window at ±4 and ±8:
    one exact forward (4 ``dcn_fwd``) and one ±R block-API forward per
    radius (4 ``dcn_block`` each)."""
    import torch

    from realvsr_tpu_torch.tools.validate_dcn_clamp import validate

    model, lq, n, _, _ = paths["edvr_noup"]
    exact = flagship(model.state_dict(), None, torch.float32)
    randomise_offset_convs(exact, seed=3, std=CLAMP_STD)
    window = read_window(lq, n)
    zero_counts()
    res = validate(exact, window, CLAMP_RADII)
    torch.cuda.synchronize()
    got = read_counts()
    k = 1 + len(CLAMP_RADII)
    expect = {"dcn_fwd": 4, "dcn_block": 4 * len(CLAMP_RADII), "dcn_bwd": 0,
              "conv3x3": k * EXPECT["edvr_noup"]["conv3x3"],
              "conv3x3_fused": k * EXPECT["edvr_noup"]["conv3x3_fused"],
              "conv3x3_narrow": 0}
    emit(phase="clamp_check", radii=list(CLAMP_RADII), dtype="float32",
         weights=f"phase 4's flagship, offset convs std {CLAMP_STD}",
         launches=got, launches_expected=expect, **res)
    if got != expect or not all(math.isfinite(v)
                                for v in res["psnr_db"].values()):
        raise AssertionError(f"clamp check: {got}, {res['psnr_db']}")
    del exact
    return got


def srmd_check():
    """SRMDPreprocessing (x4, l = 21, noise off) of a 32 x 192² batch: the
    card against the CPU from the same kernel draws, within 1e-5; timed."""
    import numpy as np
    import torch

    from realvsr_tpu_torch.ops.degradation import (SRMDPreprocessing,
                                                   pca_fit,
                                                   random_batch_kernel)

    basis = pca_fit(random_batch_kernel(np.random.default_rng(0), 256)
                    .reshape(256, -1), k=10)
    srmd = SRMDPreprocessing(4, basis, ksize=21, noise=False)
    hr = torch.rand(32, 192, 192, 3, generator=torch.Generator()
                    .manual_seed(1))
    cpu = srmd(np.random.default_rng(2), torch.Generator(), hr)
    card = srmd(np.random.default_rng(2), torch.Generator("cuda"), hr.cuda())
    errs = [(a.cpu() - b).abs().max().item() for a, b in zip(card, cpu)]
    hr_card = hr.cuda()
    ms = cuda_ms(lambda: srmd(np.random.default_rng(2),
                              torch.Generator("cuda"), hr_card), 3)
    emit(check="srmd_card_vs_cpu", shape=list(hr.shape), scale=4, ksize=21,
         lr_shape=list(card[0].shape), max_abs_err_lr=errs[0],
         max_abs_err_codes=errs[1], tol=1e-5, ms=ms)
    if max(errs[:2]) > 1e-5:
        raise AssertionError(f"SRMD card vs CPU: {errs}")


# --ab: (name, shape, c2, cout, act, residual).  The convs whose weight the
# parent streamed through a ring of 3 slots and this tree in clusters of
# two (conv3x3.cu note 7): EDVR-L's, all but upconv1 and the 300-wide
# test shape; the flagship's 64 -> 216 and 64 -> 256, and its PCD L1 (64 +
# 64) -> 64 (streamed in f32; in bf16 resident, a control)
AB_STREAMED = [case for case in EDVRL_CONVS
               if case[0] not in (UPCONV1, "300 ragged +res")] + [
    ("PCD L1 128 (64+64)->64 lrelu", (3, H, W, 64), 64, 64, "lrelu",
     False),
    ("64->216 lrelu", (3, H, W, 64), 0, 216, "lrelu", False),
    ("64->256 +res", (1, 2 * VIMEO_H, 2 * VIMEO_W, 64), 0, 256, None, True),
    (UPCONV2, (1, 2 * VIMEO_H, 2 * VIMEO_W, 64), 0, 256, "lrelu", False)]
# controls, code this tree keeps: the resident weight (the front 64 -> 64),
# column blocks (upconv1), 32-byte chunks (the debug 16 -> 16); and the C 64
# DCN forward at L1 (dcn_fwd.cu)
AB_CONTROLS = [("front 64->64 relu", (3, H, W, 64), 0, 64, "relu", False),
               EDVRL_CONVS[[c[0] for c in EDVRL_CONVS].index(UPCONV1)],
               SYNC_CASES[0]]


def per_slice_us(ms, shape, c2, dtype):
    """A weight slice's card time on one SM (one tap of one 128-byte input
    chunk against every output: time x 132 / (tiles x chunks x 9)), in
    microseconds."""
    import torch

    b, h, w, c1 = shape
    tiles = b * -(-h // 8) * -(-w // 16)
    chunks = (c1 + c2) * (2 if dtype == torch.bfloat16 else 4) // 128
    return ms * 1e3 * torch.cuda.get_device_properties(0) \
        .multi_processor_count / (tiles * chunks * 9)


def ab_parent(parent: str, *others: str) -> None:
    """``--ab PARENT [TREE ...]``: ``conv3x3.cu`` built from the tree
    unpacked at PARENT (the parent commit) and from each further TREE (a
    copy of this tree's sources with a change, for ablations; the same C
    signature) beside this tree's, timed in turns (parent, this, trees...,
    then back: parent, this, this, parent with no TREE) on the same inputs,
    each with its wrapper's allocations and weight packing, bf16 and f32:
    every AB_STREAMED conv, each with its time per weight slice
    (:func:`per_slice_us`) and cuDNN + act beside; as controls, the
    AB_CONTROLS convs and the 64-channel DCN forward at the flagship's L1
    (3, 512, 1024, 64), ±4 (``dcn_fwd.cu``, the parent's against this
    tree's).  The trees' outputs are held together first."""
    import ctypes

    import torch
    import torch.nn.functional as F

    from realvsr_tpu_torch.ops.deform_conv import apply_act
    from realvsr_tpu_torch.ops.kernels import _build
    from realvsr_tpu_torch.ops.kernels.conv3x3 import (_plan, conv3x3,
                                                       stream_plan)
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd

    P, I, F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the parent's signatures (ops/kernels/conv3x3.py, dcn.py of that tree)
    sigs = {"conv3x3": {"conv3x3": (P, I, P, I, P, P, P, P, P, I, I, I, I,
                                    I, I, P)},
            "dcn_fwd": {"dcn_fwd": (P, P, I, P, I, I, P, P, P, P, I, I, I,
                                    I, I, F32, I, P)}}
    trees = {"parent": (parent, sigs)}
    for i, tree in enumerate(others):
        trees[f"tree{i + 1}"] = (tree, {"conv3x3": sigs["conv3x3"]})
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {(label, name): subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(out_dir / f"{label}-{name}.so"),
         os.path.join(tree, "realvsr_tpu_torch", "csrc", f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for label, (tree, tsigs) in trees.items() for name in tsigs}
    fns = {}
    for (label, name), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{label} {name}: nvcc failed\n{log}")
        for kernel, regs, stores, loads in ptxas_lines(log):
            if stores or loads:  # timed all the same, spills and all
                emit(ab_spill=label, kernel=kernel, spill_stores=stores,
                     spill_loads=loads)
        so = ctypes.PyDLL(str(out_dir / f"{label}-{name}.so"))
        for fname, sig in trees[label][1][name].items():
            for dt, sfx in _build.SUFFIX.items():
                fn = getattr(so, f"{fname}_{sfx}")
                fn.argtypes, fn.restype = list(sig), ctypes.c_int
                fns[(label, fname, dt)] = fn
    emit(phase="ab build", parent=parent, trees=list(others),
         built=sorted(f"{lb}-{n}" for lb, n in procs))

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def turns(what, calls, iters, **info):
        """calls: [(label, fn)], the first the parent, the second this
        tree; run in turns there and back."""
        ref = calls[0][1]()
        for label, fn in calls[1:]:
            for r, got in zip(ref, fn()):
                if (r.float() - got.float()).abs().max() > 0.05 * max(
                        1.0, r.float().abs().max().item()):
                    raise AssertionError(f"{what} {info}: {label} and the "
                                         "parent differ")
        order = calls + calls[::-1]
        ms = {}
        for label, fn in order:
            ms.setdefault(label, []).append(cuda_ms(fn, iters))
        row = {f"{label}_ms": v for label, v in ms.items()}
        emit(ab=what, **info, **row)
        return row

    def tree_conv(fn, x, wgt, bias, act, res, x2):
        b, h, w, c1 = x.shape
        c2 = 0 if x2 is None else x2.shape[-1]
        cout, dt = wgt.shape[0], x.dtype
        _, n, _, scratch = _plan(c1, c2, cout, dt)
        packed = (torch.empty(scratch, device="cuda", dtype=dt)
                  if scratch else None)
        out = torch.empty(b, h, w, cout, device="cuda", dtype=dt)
        _build.check(fn(
            x.data_ptr(), c1, None if x2 is None else x2.data_ptr(), c2,
            wgt.data_ptr(), None if packed is None else packed.data_ptr(),
            None if bias is None else bias.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(), b, h, w,
            cout, n, _build.ACTS[act], stream()), "tree conv3x3")
        return (out,)

    def parent_dcn(x, off, mask, wgt, bias, r):
        b, h, w, c = x.shape
        dt = x.dtype
        packed = torch.empty(c * 9 * c, device="cuda", dtype=dt)
        out = torch.empty(b, h, w, c, device="cuda", dtype=dt)
        _build.check(fns[("parent", "dcn_fwd", dt)](
            x.data_ptr(), off.data_ptr(), 8 * 18, mask.data_ptr(), 8 * 9, 0,
            wgt.data_ptr(), packed.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, h, w, c, 0, float(r), 1, stream()),
            "parent dcn_fwd")
        return (out,)

    labels = list(trees)
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype)[6:]
        for cases, control in ((AB_STREAMED, False), (AB_CONTROLS, True)):
            for name, shape, c2, cout, act, residual in cases:
                x, x2, wgt, bias, res = conv_inputs(shape, c2, residual,
                                                    dtype, 61, cout)
                calls = [(lb, (lambda f=fns[(lb, "conv3x3", dtype)]:
                               tree_conv(f, x, wgt, bias, act, res, x2)))
                         for lb in labels]
                calls.insert(1, ("change", lambda: (conv3x3(
                    x, wgt, bias, act, res, x2),)))
                # the flagship's PCD L1 is resident in bf16: a control
                ctl = control or stream_plan(shape[3], c2, cout, dtype,
                                             residual) is None
                info = dict(case=name, shape=shape, c2=c2, cout=cout,
                            dtype=dname, control=ctl)
                if not ctl:
                    xcat = x if x2 is None else torch.cat([x, x2], -1)
                    x_nchw = xcat.permute(0, 3, 1, 2)
                    w_cl = wgt.contiguous(memory_format=torch.channels_last)
                    res_nchw = None if res is None else res.permute(
                        0, 3, 1, 2)

                    def library():  # cuDNN conv + bias / act / residual
                        y = apply_act(F.conv2d(x_nchw, w_cl, bias,
                                               padding=1), act)
                        return y if res_nchw is None else y + res_nchw

                    torch.backends.cudnn.allow_tf32 = dtype == torch.float32
                    info["library_ms"] = cuda_ms(library, 10)
                    torch.backends.cudnn.allow_tf32 = False
                    del xcat, x_nchw, w_cl, res_nchw
                row = turns("conv3x3", calls, 10, **info)
                if not ctl:
                    emit(ab="conv3x3 per slice", case=name, dtype=dname,
                         **{k.replace("_ms", "_us"): [
                             per_slice_us(m, shape, c2, dtype) for m in v]
                            for k, v in row.items()})
                del x, x2, res, calls
            torch.cuda.empty_cache()
        x, off, mask, wgt, bias, _ = width_inputs(DCN_CASES[0][1], 8, dtype,
                                                  63)
        turns("dcn_fwd",
              [("parent", lambda: parent_dcn(x, off, mask, wgt, bias,
                                             R_INFER)),
               ("change", lambda: (dcn_fwd(x, off, mask, wgt, bias, 8, None,
                                           R_INFER),))],
              10, shape=DCN_CASES[0][1], form="separate", dtype=dname,
              max_offset=R_INFER, control=True)
        del x, off, mask
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if sys.argv[1:2] == ["--worker"]:
        return worker(sys.argv[2])
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
    logs = _build.build(["dcn_fwd", "conv3x3", "dcn_bwd",
                         "dcn_narrow"])
    for src, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {src}.cu\n{log.strip()}")
    emit(phase="build", seconds=time.time() - t0, built=sorted(logs))
    for src, log in logs.items():
        for kernel, regs, stores, loads in ptxas_lines(log):
            emit(ptxas=src, kernel=kernel, registers=regs,
                 spill_stores=stores, spill_loads=loads)
            if stores or loads:   # every source: no spill anywhere
                raise AssertionError(f"{kernel} spills")

    if sys.argv[1:2] == ["--ab"]:
        ab_parent(*sys.argv[2:])
        print(smi())
        return 0
    profiling = "--profile" in sys.argv[1:]
    errs = check_kernels()
    bwd_errs = check_backward()
    narrow_errs = check_narrow()
    x4_errs = check_backward_x4()
    width_errs = check_widths()
    general_errs = check_general()
    with tempfile.TemporaryDirectory() as tmp:
        paths = inference_paths(tmp)
        paths["edvr_l"] = edvr_l_path(tmp, paths["edvr_x4"][1])
        launches = {p: v[-1] for p, v in paths.items()}
        launches["block_api"] = block_path()
        launches["general_dcn"] = general_dcn_path()
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
        edvr_l_train = edvr_l_training(tmp, profiling)
        for dt, res in edvr_l_train.items():
            launches[f"training_edvr_l_recipe_{dt}"] = res["launches"]
        check_warp_trilinear()
        gens = generator_paths(tmp, paths["edvr_noup"][1])
        for gen, (model, count, window) in gens.items():
            launches[gen] = count
            if profiling:
                profile(gen, model, window)
        del gens, model, window
        for gen, (cuts, side) in GEN_CASES.items():
            reduced_train_step(GEN_CFG[gen], cuts, side, "SyntheticMotion",
                               spread=True)
        reduced_gan_step()
        for dt, res in gan_recipe_training(tmp, profiling).items():
            launches[f"training_gan_{dt}"] = res["launches"]
        launches["training_debug_gan"] = gan_debug_training(tmp)
        for gen, res in generator_smoke_training(tmp).items():
            launches[f"training_{gen}_smoke"] = res["launches"]
        for (gen, dt), res in generator_recipe_training(
                tmp, profiling).items():
            launches[f"training_{gen}_recipe_{dt}"] = res["launches"]
        for (name, dt), res in wrapper_training(tmp, profiling).items():
            launches[f"training_{name}_recipe_{dt}"] = res["launches"]
        for dt, res in tof_gan_training(tmp, profiling).items():
            launches[f"training_tof_gan_{dt}"] = res["launches"]
        launches.update(streaming_phase(paths, tmp)[0])
        tiled_launches, tiled_rows = tiled_phase(paths, tmp)
        launches.update(tiled_launches)
        metrics_phase(paths, tmp)
        launches.update(wi_gt_phase(tmp))
        launches.update(parallel_phase(
            tmp, train, paths, tiled_rows["full_frame_1080p"]["ms"]))
        rows = time_kernels()
        bwd_rows = time_dcn_bwd()
        rows["dcn_bwd"] = bwd_rows["bfloat16"]
        width_rows = time_widths()
        general_rows = time_general()
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
                    c16=dict(width_rows[(kernel, "C16 dg4", "bfloat16")],
                             shape=NARROW_SHAPE,
                             launches=by_path[kernel]["training_debug_nf16"],
                             launches_per_step=debug_step[kernel],
                             max_abs_err_by_case=by_case))

    def other_widths(kernel):
        """The narrow kernels' other widths (no model of the repo runs
        them): bf16 time at the debug shape's pixels beside its bound and
        plain version, f32's, and each width's largest error over every
        case (both forms, ±4 / ±8 / exact, bf16 and f32)."""
        out = {}
        for c, dg in NARROW_WIDTHS:
            wname = f"C{c} dg{dg}"
            out[wname] = dict(
                width_rows[(kernel, wname, "bfloat16")],
                f32=width_rows[(kernel, wname, "float32")],
                shape=(*NARROW_SHAPE[:3], c), launches_on_model_paths=0,
                max_abs_err=max(e for k, e in width_errs.items()
                                if k[0] == kernel and len(k) == 5
                                and k[3] == wname))
        return dict(narrow_widths=out)

    def c128(kernel, path):
        """The (128, 8) instantiation's entry: launches on EDVR-L's paths,
        error at bf16 ±4 (L1 inference) and every case's, times (f32
        beside)."""
        errs128 = {f"{form} {shape} {dt} r={r}": e
                   for k, e in width_errs.items()
                   if len(k) == 5 and k[0] == kernel
                   for _, form, r, shape, dt in [k]
                   if shape in dict(DCN128_SHAPES)}
        return dict(
            name=f"{kernel}_c128", route="cuda",
            source=f"realvsr_tpu_torch/csrc/{kernel}.cu",
            instantiation="C = 128 in 8 deformable groups (EDVR-L)",
            replaces=("realvsr_tpu/ops/pallas/dcn_frame_kernel.py:225"
                      if kernel == "dcn_fwd" else
                      "realvsr_tpu/ops/pallas/dcn_frame_kernel.py:501"),
            launches=by_path[kernel][path],
            launches_by_path={p: v for p, v in by_path[kernel].items()
                              if "edvr_l" in p},
            max_abs_err=errs128[f"separate L infer bfloat16 r="
                                f"{R_INFER if kernel == 'dcn_fwd' else 8}"],
            max_abs_err_by_case=errs128,
            f32=width_rows[(kernel, "c128", "float32")],
            **width_rows[(kernel, "c128", "bfloat16")])

    def general(kernel):
        """The generalised dcn_narrow.cu (any cin -> cout, no mask): its
        launches on the general DCN path, its largest error over every
        GENERAL_DCN case (both forms, ±4 and exact, bf16 and f32), and its
        times at GENERAL_TIMED (bf16, f32 beside); the row's own numbers
        are the first timed case's."""
        cases = {}
        for cin, cout, dg, m in GENERAL_TIMED:
            case = f"{cin}->{cout} dg{dg}{'' if m else ' v1'}"
            cases[case] = dict(general_rows[(kernel, case, "bfloat16")],
                               f32=general_rows[(kernel, case, "float32")],
                               shape=(*NARROW_SHAPE[:3], cin), cout=cout,
                               mask=m)
        case = GENERAL_L1[0]
        cases[case] = dict(general_rows[(kernel, case, "bfloat16")],
                           f32=general_rows[(kernel, case, "float32")],
                           shape=DCN_CASES[0][1], cout=GENERAL_L1[2],
                           mask=False)
        by_case = {f"{case} {form} {dt} r={r}": e
                   for k, e in general_errs.items() if len(k) == 5
                   and k[0] == kernel for _, form, r, case, dt in [k]}
        first = next(iter(cases))
        return dict(
            name=f"{kernel}_general", route="cuda",
            source="realvsr_tpu_torch/csrc/dcn_narrow.cu",
            instantiation="any cin -> cout with dg dividing cin, with or "
                          "without a mask (the generalised dcn_narrow.cu)",
            replaces=("realvsr_tpu/ops/pallas/dcn_frame_kernel.py:225"
                      if kernel == "dcn_fwd" else
                      "realvsr_tpu/ops/pallas/dcn_frame_kernel.py:501"),
            launches=by_path[kernel]["general_dcn"],
            launches_by_path={p: v for p, v in by_path[kernel].items()
                              if p == "general_dcn"},
            max_abs_err=max(by_case.values()), max_abs_err_by_case=by_case,
            deform_conv_module_max_abs_err={
                f"p{pad} {dt}": e for k, e in general_errs.items()
                if len(k) == 3 for _, pad, dt in [k]},
            timed_cases=cases, timed_case=first,
            **{k: v for k, v in cases[first].items()
               if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")})

    def conv_cases(kernel, cases):
        """Each conv case's bf16 time row (route, bound, cuDNN), f32's
        beside, and its bf16 and f32 errors against the plain version."""
        return {name: dict(width_rows[(kernel, name, "bfloat16")],
                           f32=width_rows[(kernel, name, "float32")],
                           max_abs_err=width_errs[(kernel, name,
                                                   "bfloat16")],
                           max_abs_err_f32=width_errs[(kernel, name,
                                                       "float32")])
                for name, *_ in cases}

    narrow_cases = conv_cases("conv3x3_narrow", SYNC_CASES)
    kernels = [
        dict(name="dcn_fwd", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_fwd.cu",
             replaces="realvsr_tpu/ops/pallas/dcn_frame_kernel.py:225",
             launches=by_path["dcn_fwd"]["training_float32"],
             launches_by_path=by_path["dcn_fwd"],
             max_abs_err=errs[("dcn_fwd", "L1", bf, 4)],
             **c16("dcn_fwd"), **other_widths("dcn_fwd"),
             **rows[("dcn_fwd", "L1", "bfloat16")]),
        c128("dcn_fwd", "edvr_l"),
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
             nf128_and_wide_cases=conv_cases("conv3x3_fused", EDVRL_CONVS),
             **rows[("conv3x3_fused", UPCONV2, "bfloat16")]),
        dict(name="conv3x3_narrow", route="cuda",
             source="realvsr_tpu_torch/csrc/conv3x3.cu",
             replaces="realvsr_tpu/ops/pallas/conv3x3_kernel.py:125",
             instantiation="input widths that are not whole 128-byte "
                           "chunks (the nf 16 debug configs' convs): the "
                           "wgmma kernel on 32-byte chunks, the weight "
                           "laid out by its blocks (one launch)",
             launches=by_path["conv3x3_narrow"]["training_debug_nf16"],
             launches_by_path={p: v for p, v in
                               by_path["conv3x3_narrow"].items() if v},
             launches_per_step=debug_step["conv3x3_narrow"],
             max_abs_err=max([errs[("conv3x3_narrow", bf)]]
                             + [c["max_abs_err"]
                                for c in narrow_cases.values()]),
             timed_case=SYNC_CASES[0][0], cases=narrow_cases,
             **{k: v for k, v in narrow_cases[SYNC_CASES[0][0]].items()
                if k in ("ms", "plain_ms", "bound_ms", "bound_by",
                         "library_ms", "device_ms", "library_device_ms")}),
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
             **other_widths("dcn_bwd"), **rows["dcn_bwd"]),
        c128("dcn_bwd", "training_edvr_l_recipe_float32"),
        dict(name="dcn_block", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_fwd.cu",
             wrapper="realvsr_tpu_torch/ops/deform_conv_block.py",
             replaces="realvsr_tpu/ops/pallas/dcn_block_kernel.py:82",
             launches=by_path["dcn_block"]["block_api"],
             launches_by_path=by_path["dcn_block"],
             max_abs_err=errs[("dcn_block", bf, R_INFER)],
             max_abs_err_c128={dt: width_errs[("dcn_block", "c128", dt)]
                               for dt in ("bfloat16", "float32")},
             **rows["dcn_block"]),
        general("dcn_fwd"),
        general("dcn_bwd"),
    ]
    idle = [k["name"] for k in kernels if not k["launches"]]
    if idle:
        raise AssertionError(f"kernels never launched on their path: {idle}")
    emit(phase="done", seconds=time.time() - t_start)
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
