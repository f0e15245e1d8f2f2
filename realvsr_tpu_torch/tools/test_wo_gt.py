"""No-reference inference command line (the reference test_RealVSR_wo_GT.py).

    python -m realvsr_tpu_torch.tools.test_wo_gt -opt configs/test/<cfg>.yml

Runs on ``--device`` (default ``cuda``); ``path.pretrain_model_G`` is a
torch state dict (a reference ``.pth``).

``--flip_test`` averages the four flipped forwards of each window;
``--streaming`` restores each sequence as a stream, each frame's pyramid
computed once (EDVR models); ``--tile H W [--overlap P]`` restores each
window in H x W tiles run as one batch on the device.
"""
from __future__ import annotations

from realvsr_tpu_torch.eval.test_wo_gt import restore_wo_gt
from realvsr_tpu_torch.tools._cli import parse_args, restorer, setup


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    opt, results_root, model = setup(args)
    ds = opt["datasets"]["test"]
    return restore_wo_gt(
        restorer(args, opt, model), lq_root=ds["dataroot_LQ"],
        color=ds.get("color") or "YCbCr",
        save_folder=results_root if args.save_imgs else None)


if __name__ == "__main__":
    main()
