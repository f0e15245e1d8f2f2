"""No-reference metric tables (the reference's
``codes/metrics/evaluate_realvsr_no_reference_metrics.m`` and
``evaluate_niqe_brisque.m``; the port's counterpart of
``tools/evaluate_no_reference.py``): per-sequence NIQE / BRISQUE.

    python -m realvsr_tpu_torch.tools.evaluate_no_reference --results <root> \
        [--metrics niqe brisque] [--niqe-model model.npz | matlab_model.mat] \
        [--brisque-model allmodel --brisque-range allrange] \
        [--device cuda|cpu]

NIQE models: an .npz from ``realvsr_tpu_torch.eval.niqe.fit_niqe_model``
or a MATLAB fitniqe .mat (decoded directly).  BRISQUE takes the original
release's libsvm model files.  The features run on ``--device`` (default
``cuda``) in float64.
"""
from __future__ import annotations

import argparse
import glob
import os.path as osp

import numpy as np

from realvsr_tpu_torch.data.imageio import read_gray


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--results", required=True)
    parser.add_argument("--metrics", nargs="+", default=["niqe"],
                        choices=["niqe", "brisque"])
    parser.add_argument("--niqe-model", default=None)
    parser.add_argument("--brisque-model", default=None)
    parser.add_argument("--brisque-range", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from realvsr_tpu_torch.eval import brisque as B
    from realvsr_tpu_torch.eval import niqe as N

    scorers = {}
    if "niqe" in args.metrics:
        if not args.niqe_model:
            parser.error("--niqe-model required for NIQE")
        model = (N.load_matlab_niqe_model(args.niqe_model)
                 if args.niqe_model.endswith(".mat")
                 else dict(np.load(args.niqe_model)))
        scorers["niqe"] = lambda img, m=model: N.niqe_score(
            img, m, device=args.device)
    if "brisque" in args.metrics:
        if not (args.brisque_model and args.brisque_range):
            parser.error("--brisque-model/--brisque-range required for "
                         "BRISQUE")
        model = B.load_libsvm_model(args.brisque_model, args.brisque_range)
        scorers["brisque"] = lambda img, m=model: B.brisque_score(
            img, m, device=args.device)

    seq_dirs = [d for d in sorted(glob.glob(osp.join(args.results, "*")))
                if osp.isdir(d)]
    totals = {m: [] for m in args.metrics}
    for seq_dir in seq_dirs:
        vals = {m: [] for m in args.metrics}
        for p in sorted(glob.glob(osp.join(seq_dir, "*.png"))):
            img = read_gray(p)
            for m, fn in scorers.items():
                vals[m].append(fn(img))
        print(f"{osp.basename(seq_dir)}: " + "  ".join(
            f"{m}={np.mean(vals[m]):.4f}" for m in args.metrics))
        for m in args.metrics:
            totals[m].append(np.mean(vals[m]))
    print("==== total ====")
    for m in args.metrics:
        print(f"{m}: {np.mean(totals[m]):.4f} over {len(totals[m])} "
              "sequences")
    return {m: float(np.mean(v)) for m, v in totals.items()}


if __name__ == "__main__":
    main()
