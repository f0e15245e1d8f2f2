"""No-reference inference command line (the reference test_RealVSR_wo_GT.py).

    python -m realvsr_tpu_torch.tools.test_wo_gt -opt configs/test/<cfg>.yml

Runs on ``--device`` (default ``cuda``); ``path.pretrain_model_G`` is a
torch state dict (a reference ``.pth``).
"""
from __future__ import annotations

from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt
from realvsr_tpu_torch.tools._cli import parse_args, setup


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    opt, results_root, model = setup(args)
    ds = opt["datasets"]["test"]
    return evaluate_wo_gt(
        model, None, lq_root=ds["dataroot_LQ"],
        n_frames=opt["network_G"]["nframes"],
        color=ds.get("color") or "YCbCr",
        padding=ds.get("padding") or "replicate",
        flip_test=args.flip_test,
        save_folder=results_root if args.save_imgs else None)


if __name__ == "__main__":
    main()
