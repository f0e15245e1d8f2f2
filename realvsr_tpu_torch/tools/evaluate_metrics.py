"""Full-reference metric tables over result folders (the reference's
``codes/metrics/evaluate_realvsr_full_reference_metrics.py``; the port's
counterpart of ``tools/evaluate_metrics.py``).

    python -m realvsr_tpu_torch.tools.evaluate_metrics --results <root> \
        --gt <gt_root> [--metrics psnr ssim lpips dists] [--y-only] \
        [--vgg16-weights vgg16.pth] [--lpips-weights LPIPSvgg.pt] \
        [--dists-weights DISTS.pt] [--device cuda|cpu]

Per-sequence and total PSNR / SSIM (MATLAB-equivalent, on the host) and
LPIPS / DISTS (``realvsr_tpu_torch/eval/perceptual.py``, on ``--device``,
default ``cuda``).  LPIPS / DISTS take a torchvision vgg16 state dict
(``--vgg16-weights``) and the metric heads (``--lpips-weights`` /
``--dists-weights``, or one combined dump in ``--vgg16-weights``); without
weight files they warn and run a random init, whose scores only show that
the pipeline runs.
"""
from __future__ import annotations

import argparse
import glob
import os.path as osp

import cv2
import numpy as np

from realvsr_tpu_torch.ops.color import bgr2ycbcr_np
from realvsr_tpu_torch.ops.metrics import calculate_psnr_np, calculate_ssim_np


def _build_perceptual(args) -> dict:
    """{'lpips': fn, 'dists': fn} for the requested metrics; fn maps
    (result, gt) NHWC RGB [0, 1] batches to per-image scores."""
    from realvsr_tpu_torch.eval import perceptual as P

    out = {}
    for name, load, score in (("lpips", P.load_lpips_weights, P.lpips),
                              ("dists", P.load_dists_weights, P.dists)):
        if name not in args.metrics:
            continue
        if args.vgg16_weights:
            params = load(args.vgg16_weights,
                          getattr(args, f"{name}_weights"), args.device)
        else:
            print(f"WARNING: --vgg16-weights not given; {name.upper()} uses "
                  "random init (wiring test only, scores are meaningless)")
            params = P.init_lpips_params(with_dists=name == "dists",
                                         device=args.device)
        out[name] = (lambda x, y, params=params, score=score:
                     score(params, x, y))
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--results", required=True)
    parser.add_argument("--gt", required=True)
    parser.add_argument("--metrics", nargs="+", default=["psnr", "ssim"],
                        choices=["psnr", "ssim", "lpips", "dists"])
    parser.add_argument("--y-only", action="store_true",
                        help="evaluate PSNR/SSIM on the Y channel of YCbCr")
    parser.add_argument("--vgg16-weights", default=None,
                        help="torchvision vgg16 state_dict .pth")
    parser.add_argument("--lpips-weights", default=None,
                        help="LPIPS linear-head checkpoint (official or "
                             "IQA_pytorch format)")
    parser.add_argument("--dists-weights", default=None,
                        help="DISTS alpha/beta checkpoint")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    perceptual = _build_perceptual(args)
    seq_dirs = [d for d in sorted(glob.glob(osp.join(args.results, "*")))
                if osp.isdir(d)]
    totals = {m: [] for m in args.metrics}
    for seq_dir in seq_dirs:
        name = osp.basename(seq_dir)
        vals = {m: [] for m in args.metrics}
        for rp in sorted(glob.glob(osp.join(seq_dir, "*.png"))):
            gp = osp.join(args.gt, name, osp.basename(rp))
            res = cv2.imread(rp).astype(np.float64)
            gt = cv2.imread(gp).astype(np.float64)
            for m, fn in perceptual.items():
                # BGR uint8 -> RGB [0, 1] NHWC, like prepare_image (ToTensor
                # of a PIL RGB image)
                r = (res[..., ::-1] / 255.0).astype(np.float32)[None]
                g = (gt[..., ::-1] / 255.0).astype(np.float32)[None]
                vals[m].append(float(fn(r, g)[0]))
            if args.y_only:
                res = bgr2ycbcr_np(res / 255.0, only_y=True) * 255.0
                gt = bgr2ycbcr_np(gt / 255.0, only_y=True) * 255.0
            if "psnr" in vals:
                vals["psnr"].append(calculate_psnr_np(res, gt))
            if "ssim" in vals:
                vals["ssim"].append(calculate_ssim_np(res, gt))
        print(f"{name}: " + "  ".join(f"{m}={np.mean(vals[m]):.4f}"
                                      for m in args.metrics))
        for m in args.metrics:
            totals[m].append(np.mean(vals[m]))
    print("==== total ====")
    for m in args.metrics:
        print(f"{m}: {np.mean(totals[m]):.4f} over {len(totals[m])} "
              "sequences")
    return {m: float(np.mean(v)) for m, v in totals.items()}


if __name__ == "__main__":
    main()
