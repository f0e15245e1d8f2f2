"""Full-reference evaluation command line (the reference
test_RealVSR_wi_GT.py).

    python -m realvsr_tpu_torch.tools.test_wi_gt -opt configs/test/<cfg>.yml

The YAML needs network_G, path.pretrain_model_G (a torch state dict) and
datasets.test {dataroot_LQ, dataroot_GT, N_frames, color, padding}.  Runs
on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

from realvsr_tpu_torch.eval.test_wi_gt import evaluate_wi_gt
from realvsr_tpu_torch.tools._cli import parse_args, setup


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    opt, results_root, model = setup(args)
    ds = opt["datasets"]["test"]
    return evaluate_wi_gt(
        model, None, lq_root=ds["dataroot_LQ"], gt_root=ds["dataroot_GT"],
        n_frames=opt["network_G"]["nframes"],
        color=ds.get("color") or "YCbCr",
        padding=ds.get("padding") or "replicate",
        crop_border=int(ds.get("crop_border") or 0),
        flip_test=args.flip_test,
        save_folder=results_root if args.save_imgs else None)


if __name__ == "__main__":
    main()
