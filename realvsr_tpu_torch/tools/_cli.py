"""Shared set-up of the evaluation command lines: arguments, logger, model
and weights from a test YAML."""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp
from functools import partial

import torch

from realvsr_tpu_torch.core.config import parse
from realvsr_tpu_torch.eval.sliding_window import (
    CLIP_IDS, make_forward, sliding_window_infer, to_host)
from realvsr_tpu_torch.eval.streaming import StreamingRunner
from realvsr_tpu_torch.eval.tiled import make_batched_tiled_forward
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.train.checkpoint import load_network

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def parse_args(argv, doc: str) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=doc)
    parser.add_argument("-opt", type=str, required=True, help="test YAML")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dtype", choices=sorted(_DTYPES), default="float32")
    parser.add_argument("--max_offset", type=float, default=None,
                        help="clamp DCN offsets to ±R (default: exact)")
    parser.add_argument("--save_imgs", action="store_true")
    parser.add_argument("--flip_test", action="store_true")
    parser.add_argument("--streaming", action="store_true",
                        help="restore each sequence as a stream, each "
                             "frame's pyramid computed once (EDVR models)")
    parser.add_argument("--tile", type=int, nargs=2, metavar=("H", "W"),
                        default=None,
                        help="restore each window in H x W tiles, run as "
                             "one batch on the device")
    parser.add_argument("--overlap", type=int, default=32,
                        help="pixels of overlap of the tiles (--tile)")
    return parser.parse_args(argv)


def restorer(args, opt, model):
    """``frames (T, H, W, C) -> iterator of (frame index, float32 numpy
    output)`` as the arguments ask, on the device that holds the model's
    weights: ``--streaming`` through
    :meth:`~realvsr_tpu_torch.eval.streaming.StreamingRunner.run_lazy`
    (EDVR models; no flips, no tiles); else the sliding window of the
    model's ``nframes``, each window restored whole or, with ``--tile H W``,
    in tiles run as one batch
    (:func:`~realvsr_tpu_torch.eval.tiled.make_batched_tiled_forward`),
    ``--flip_test`` averaging its four flipped forwards.

    Each frame is the caller's own float32 array, in pinned host memory
    when the model runs on CUDA (``eval/sliding_window.py::Download``).
    The sliding window runs one window ahead from the second ask, its next
    forward queued before a frame's download is waited for;
    ``--streaming`` downloads each frame through
    :func:`~realvsr_tpu_torch.eval.sliding_window.to_host` as its stream
    yields it, with no look-ahead."""
    padding = opt["datasets"]["test"].get("padding") or "replicate"
    device = next(model.parameters()).device
    if args.streaming:
        if args.flip_test or args.tile is not None:
            raise ValueError("streaming takes no flip test and no tiles")
        runner = StreamingRunner(model, None, padding, device)

        def stream(frames):
            clip = next(CLIP_IDS)
            return ((t, to_host(out, (clip, t)))
                    for t, out in enumerate(runner.run_lazy(frames)))
        return stream
    if args.tile is not None:
        forward = make_batched_tiled_forward(
            model, None, tuple(args.tile), args.overlap,
            int(opt.get("scale") or 1), device)
    else:
        forward = make_forward(model)
    return partial(sliding_window_infer, forward,
                   n_frames=opt["network_G"]["nframes"], padding=padding,
                   flip_test=args.flip_test, device=device)


def setup_logger(log_dir: str, name: str = "base") -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(logging.INFO)
    lg.propagate = False
    if not lg.handlers:
        fmt = logging.Formatter(
            "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
            datefmt="%y-%m-%d %H:%M:%S")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        lg.addHandler(sh)
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(osp.join(log_dir, "test.log"))
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    return lg


def setup(args):
    """(opt, results_root, model) with weights loaded from
    ``path.pretrain_model_G`` when the YAML names one."""
    opt = parse(args.opt, is_train=False)
    results_root = opt["path"]["results_root"]
    logger = setup_logger(results_root)
    model = define_g(opt, device=args.device, dtype=_DTYPES[args.dtype],
                     dcn_max_offset=args.max_offset)
    pretrain = opt["path"].get("pretrain_model_G")
    if pretrain:
        strict = opt["path"].get("strict_load")
        model.load_state_dict(load_network(pretrain),
                              strict=True if strict is None else bool(strict))
    else:
        logger.warning("No pretrain_model_G given — evaluating randomly "
                       "initialized G.")
    return opt, results_root, model
