"""Shared set-up of the evaluation command lines: arguments, logger, model
and weights from a test YAML."""
from __future__ import annotations

import argparse
import logging
import os
import os.path as osp

import torch

from realvsr_tpu_torch.core.config import parse
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
    return parser.parse_args(argv)


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
