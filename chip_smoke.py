#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``realvsr_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the main path from ``realvsr_tpu_torch/csrc`` with
   nvcc, in parallel, and print ``-Xptxas -v``;
3. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, in bf16 and f32, with the tolerance of
   ``realvsr_tpu_torch/ops/kernels/check.py``;
4. the main path: EDVR_NoUp at full width (nf 64, 3 frames, 8 deformable
   groups, 5 + 10 ResBlocks, no TSA, DCN offsets clamped to ±4 as the JAX
   package's deployment setting), bf16, seeded random weights with
   randomised DCN offset convs, through ``evaluate_wo_gt`` on a seeded
   synthetic 5-frame 1024x512 PNG clip, with the kernels' launch counts
   read around that run; then the same weights at 64x128 on the card (f32
   and bf16) against the CPU in f32;
5. times: each kernel, its plain version and the one PyTorch call that
   computes the same function (where there is one) with CUDA events at the
   main path's shapes, and the slice's frames/s at 1024x512.

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


def emit(**kv):
    print(json.dumps(kv), flush=True)


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
    """(least ms, "bytes" | "operations") from data-sheet peaks."""
    t_bytes = bytes_moved / PEAK_BYTES_S
    t_ops = tc_flops / PEAK_TC_FLOPS[dtype] + f32_flops / PEAK_F32_FLOPS
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
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd

    cfg = dict(nf=64, nc=3, nframes=NFRAMES, groups=8, front_RBs=5,
               back_RBs=10, w_TSA=False, dcn_max_offset=4)
    model = EDVRNoUp(**cfg, device="cuda", dtype=torch.bfloat16,
                     generator=torch.Generator().manual_seed(0))
    randomise_offset_convs(model, seed=1)
    lq_root = write_clip(tmp, seed=2)
    out_dir = os.path.join(tmp, "out")

    dcn_fwd.launches = 0
    conv3x3.launches = 0
    res = evaluate_wo_gt(model, None, lq_root, n_frames=NFRAMES,
                         save_folder=out_dir)
    torch.cuda.synchronize()
    launches = {"dcn_fwd": dcn_fwd.launches, "conv3x3": conv3x3.launches}
    per_window = {k: v / CLIP for k, v in launches.items()}
    emit(phase="main_path", windows=CLIP, launches=launches,
         launches_per_window=per_window, frames_per_s_first_run=res[
             "frames_per_s"])
    if per_window["dcn_fwd"] < 4 or per_window["conv3x3"] < 41:
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
    logs = _build.build(["dcn_fwd", "conv3x3"])
    for src, log in logs.items():
        print(f"--- nvcc -Xptxas -v: {src}.cu\n{log.strip()}")
    emit(phase="build", seconds=time.time() - t0, built=sorted(logs))

    errs = check_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        model, lq_root, launches = main_path(tmp)
        rows = time_kernels()
        window = time_slice(model, lq_root)
        if "--profile" in sys.argv[1:]:
            profile(model, window)

    bf = torch.bfloat16
    kernels = [
        dict(name="dcn_fwd", route="cuda",
             source="realvsr_tpu_torch/csrc/dcn_fwd.cu",
             replaces="realvsr_tpu/ops/pallas/dcn_frame_kernel.py:225",
             launches=launches["dcn_fwd"],
             max_abs_err=errs[("dcn_fwd", "L1", bf, 4)],
             **rows[("dcn_fwd", "L1")]),
        dict(name="conv3x3", route="cuda",
             source="realvsr_tpu_torch/csrc/conv3x3.cu",
             replaces="realvsr_tpu/ops/pallas/conv3x3_kernel.py:447",
             launches=launches["conv3x3"],
             max_abs_err=errs[("conv3x3", "front 64->64 relu", bf)],
             **rows[("conv3x3", "front 64->64 relu")]),
    ]
    emit(phase="done", seconds=time.time() - t_start)
    print(smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
