"""Full-reference evaluation command line (the reference
test_RealVSR_wi_GT.py).

    python -m realvsr_tpu_torch.tools.test_wi_gt -opt configs/test/<cfg>.yml

The YAML needs network_G, path.pretrain_model_G (a torch state dict) and
datasets.test {dataroot_LQ, dataroot_GT, N_frames, color, padding}.  Runs
on ``--device`` (default ``cuda``).  A recurrent model (BasicVSR++, no
``nframes``) restores whole clips, every frame counted as a centre one.

``--flip_test`` averages the four flipped forwards of each window;
``--streaming`` restores each sequence as a stream, each frame's pyramid
computed once (EDVR models); ``--tile H W [--overlap P]`` restores each
window in H x W tiles run as one batch on the device.
"""
from __future__ import annotations

from realvsr_tpu_torch.eval.test_wi_gt import restore_wi_gt
from realvsr_tpu_torch.tools._cli import parse_args, restorer, setup


def main(argv=None) -> dict:
    args = parse_args(argv, __doc__)
    opt, results_root, model = setup(args)
    ds = opt["datasets"]["test"]
    return restore_wi_gt(
        restorer(args, opt, model), lq_root=ds["dataroot_LQ"],
        gt_root=ds["dataroot_GT"], n_frames=opt["network_G"]["nframes"] or 1,
        color=ds.get("color") or "YCbCr",
        crop_border=int(ds.get("crop_border") or 0),
        save_folder=results_root if args.save_imgs else None)


if __name__ == "__main__":
    main()
