"""Training command line (the reference's ``codes/train.py``):

    python -m realvsr_tpu_torch.tools.train -opt configs/train/<experiment>.yml \
        [--dcn_max_offset R] [--device cuda|cpu] [--profile]
    torchrun --nproc_per_node N -m realvsr_tpu_torch.tools.train -opt ...

Runs on one device, the card unless ``--device cpu``; under ``torchrun``
each of the N processes drives ``cuda:LOCAL_RANK`` (or the CPU) and takes
1/N of every batch (``train/trainer.py``), over ``nccl`` on the card and
``gloo`` on the CPU.  The DCN offsets are
clamped to ±8 px unless ``--dcn_max_offset`` says otherwise (0: the exact
DCN), as the JAX package trains its frame path.  ``--profile`` writes a
torch.profiler trace of steps 10-15 to ``<experiments_root>/profile``:
``trace.json`` (Chrome trace format), ``summary.txt`` (ops by time) and
``spans.json``, the port's own spans and counters of those steps
(``realvsr_tpu_torch/utils/trace.py``: the loop's upload and step, the
step's phases, each kernel call with its shape, the loader thread's fetch,
collate and queue) in Unix nanoseconds, the clock torch.profiler puts its
events on.
"""
from __future__ import annotations

import argparse
import sys

import torch

from realvsr_tpu_torch.core.config import parse
from realvsr_tpu_torch.train.trainer import Trainer

DCN_MAX_OFFSET = 8.0  # ±R px, the JAX package's frame-path training default


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-opt", type=str, required=True,
                        help="Path to option YAML file.")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--dcn_max_offset", type=float, default=DCN_MAX_OFFSET,
                        help="±R clamp of the DCN offsets; 0 = exact")
    parser.add_argument("--profile", action="store_true",
                        help="torch.profiler trace of steps 10-15")
    args = parser.parse_args(argv)
    opt = parse(args.opt, is_train=True)
    trainer = Trainer(opt, device=args.device,
                      dcn_max_offset=args.dcn_max_offset or None)
    if args.profile:
        trainer.profile_steps = (10, 15)
    try:
        return trainer.train()
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
