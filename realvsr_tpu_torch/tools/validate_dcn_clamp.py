"""Validate the ±R DCN offset clamp of a model: (a) the distribution of its
PCD offset magnitudes, (b) the PSNR of its output through the ±R block DCN
against the exact DCN.

    python -m realvsr_tpu_torch.tools.validate_dcn_clamp \\
        [--ckpt <.pth | Orbax dir>] [--frames d1.png d2.png d3.png | \\
        --motion_seq S] [--hw 256 512] [--radii 4 8] [--nf 64] \\
        [--device cuda|cpu] [--dtype float32|bfloat16]

Counterpart of ``tools/validate_dcn_clamp.py`` for the flagship EDVR_NoUp
(nf, 8 groups, 5 + 10 ResBlocks, no TSA).  The exact forward runs the
model's DCN unclamped (on the card: the DCN forward kernel,
``csrc/dcn_fwd.cu``); each ±R forward routes every ``DCNPack`` through the
block DCN API (``ops/deform_conv_block.py``, the TPU's block kernel's
counterpart).  The offsets are DCNPack's raw offsets (before any clamp),
collected in the block forward at max(R, 8), as the JAX tool collects
them.  Without ``--ckpt`` the model is randomly initialised with its
zero-initialised offset convs: near-zero offsets, a smoke run, not
evidence; pass a trained checkpoint.  An Orbax directory of the JAX
package is converted first with ``tools/orbax_to_pth.py`` in a subprocess
(it needs JAX installed).  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os.path as osp
import subprocess
import sys
import tempfile
from contextlib import contextmanager

import numpy as np
import torch
import torch.nn.functional as F

from realvsr_tpu_torch.models.common import DCNPack
from realvsr_tpu_torch.ops.deform_conv import apply_act
from realvsr_tpu_torch.ops.deform_conv_block import (
    modulated_deform_conv_block)

NET = dict(nc=3, nframes=3, groups=8, front_RBs=5, back_RBs=10,
           w_TSA=False)


@contextmanager
def block_dcn(model, radius: int, offsets: list | None = None):
    """Inside, every ``DCNPack`` of ``model`` runs the block DCN API at
    ±``radius``; with ``offsets``, each pack's raw offsets are appended to
    it (|offset| on the host, float32)."""
    packs = [m for m in model.modules() if isinstance(m, DCNPack)]

    def forward(pack, x, offset_feat, act=None):
        om = pack.conv_offset_mask(offset_feat)
        n_off = 2 * pack.deformable_groups * 9
        off = om[..., :n_off].contiguous()
        if offsets is not None:
            offsets.append(off.float().abs().flatten().cpu().numpy())
        mask = torch.sigmoid(om[..., n_off:].float()).to(x.dtype).contiguous()
        y = modulated_deform_conv_block(
            x, off, mask, pack.weight.to(x.dtype), pack.bias.to(x.dtype), 1,
            pack.deformable_groups, radius)
        return apply_act(y, act)

    for p in packs:
        p.forward = forward.__get__(p)
    try:
        yield
    finally:
        for p in packs:
            del p.forward


def validate(model, x: torch.Tensor, radii=(4, 8)) -> dict:
    """Offset statistics and the ±R block path's PSNR against the exact DCN
    of ``model`` (built without a clamp) on the window ``x`` (B, 3, H, W,
    C) on the model's device."""
    if any(m.max_offset is not None for m in model.modules()
           if isinstance(m, DCNPack)):
        raise ValueError("build the model without dcn_max_offset: its own "
                         "forward is the exact reference")
    model.eval()
    collect_r = max(max(radii), 8)
    offsets, outs = [], {}
    with torch.inference_mode():
        ref = model(x).float()
        for r in sorted(set(radii) | {collect_r}):
            with block_dcn(model, r, offsets if r == collect_r else None):
                outs[r] = model(x).float()
    mags = np.concatenate(offsets)
    res = {"offsets": int(mags.size),
           "percentiles_px": {p: float(np.percentile(mags, p))
                              for p in (50, 90, 99, 99.9, 100)},
           "within": {r: float((mags <= r).mean()) for r in radii},
           "psnr_db": {}, "max_abs_diff": {}}
    for r in radii:
        mse = float(((ref - outs[r]) ** 2).mean())
        res["psnr_db"][r] = 10 * np.log10(1.0 / max(mse, 1e-12))
        res["max_abs_diff"][r] = float((ref - outs[r]).abs().max())
    return res


def _window(args, device) -> torch.Tensor:
    h, w = args.hw
    if args.motion_seq is not None:
        from realvsr_tpu_torch.data.synthetic import (_degrade_realistic,
                                                      _motion_frame)

        s = args.motion_seq
        frames = [_degrade_realistic(_motion_frame(s, t, h, w),
                                     np.random.default_rng(s * 1000 + t))
                  for t in range(1, 4)]
    elif args.frames:
        import cv2

        frames = [cv2.imread(p).astype(np.float32)[..., ::-1][:h, :w] / 255.0
                  for p in args.frames]
    else:   # a coarse random texture shifted 2 px a frame, bicubic up
        base = np.random.default_rng(0).random(
            (1, 3, h // 8, w // 8)).astype(np.float32)
        frames = [F.interpolate(torch.from_numpy(np.roll(base, 2 * t, -1)),
                                (h, w), mode="bicubic", align_corners=False)
                  [0].permute(1, 2, 0).numpy() for t in range(3)]
    return torch.from_numpy(np.ascontiguousarray(np.stack(frames)[None])).to(
        device)


def _state_dict(ckpt: str, nf: int) -> dict:
    from realvsr_tpu_torch.train.checkpoint import load_network

    if not osp.isdir(ckpt):
        return load_network(ckpt)
    import yaml

    with tempfile.TemporaryDirectory() as tmp:
        cfg, out = osp.join(tmp, "net.yml"), osp.join(tmp, "g.pth")
        with open(cfg, "w") as f:
            yaml.safe_dump({"scale": 1, "network_G": dict(
                NET, which_model_G="EDVR_NoUp", nf=nf, predeblur=False,
                HR_in=False)}, f)
        tool = osp.join(osp.dirname(osp.dirname(osp.dirname(
            osp.abspath(__file__)))), "tools", "orbax_to_pth.py")
        subprocess.run([sys.executable, tool, "-opt", cfg, "--ckpt", ckpt,
                        "--out", out], check=True)
        return load_network(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--ckpt", default=None)
    parser.add_argument("--frames", nargs="*", default=None)
    parser.add_argument("--motion_seq", type=int, default=None,
                        help="3 LQ frames of a held-out motion-synthetic "
                             "sequence (ids >= 100) instead of --frames")
    parser.add_argument("--hw", nargs=2, type=int, default=[256, 512])
    parser.add_argument("--radii", nargs="+", type=int, default=[4, 8])
    parser.add_argument("--nf", type=int, default=64)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=["float32", "bfloat16"],
                        default="float32")
    args = parser.parse_args(argv)
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    dtype = getattr(torch, args.dtype)
    model = EDVRNoUp(nf=args.nf, **NET, device=args.device, dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    if args.ckpt:
        model.load_state_dict(_state_dict(args.ckpt, args.nf), strict=True)
    res = validate(model, _window(args, args.device), args.radii)
    print(f"offsets collected: {res['offsets']:,d}")
    for p, v in res["percentiles_px"].items():
        print(f"  |offset| p{p}: {v:.3f} px")
    for r, frac in res["within"].items():
        print(f"  fraction within ±{r}: {frac:.6f}")
    for r in args.radii:
        print(f"block R={r} vs exact: PSNR {res['psnr_db'][r]:.2f} dB, "
              f"max|Δ| {res['max_abs_diff'][r]:.2e}")
    return res


if __name__ == "__main__":
    main()
