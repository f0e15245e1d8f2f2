"""LR schedules as plain step → lr functions.

Counterparts of ``realvsr_tpu/schedules/__init__.py``, which reproduces the
reference's stateful torch schedulers (``codes/models/lr_scheduler.py``) in
closed form with their off-by-one conventions: the reference steps the
scheduler before each iteration (``base_model.py:52-64``), so the LR at
training step k (1-based) is the scheduler's value at ``last_epoch = k``;
restarts fire at ``restart_iter + 1`` (lr_scheduler.py:15, 41); a linear
warmup overrides the LR for ``step < warmup_iter`` (base_model.py:56-63).

:func:`lr_scheduler` drives an optimizer with one of these through
``torch.optim.lr_scheduler.LambdaLR`` at ``count + 1``, as
``realvsr_tpu/train/state.py`` drives optax.
"""
from __future__ import annotations

import math
from bisect import bisect_right
from collections import Counter

import torch


def cosine_annealing_restart(base_lr: float, t_period, restarts=None,
                             weights=None, eta_min: float = 0.0):
    """CosineAnnealingLR_Restart (lr_scheduler.py:35-64) in closed form."""
    restarts = [v + 1 for v in (restarts or [])]
    weights = list(weights or [])
    if len(restarts) != len(weights):
        raise ValueError("restarts and weights must match")
    seg_start = [0] + restarts
    seg_weight = [1.0] + [float(w) for w in weights]
    seg_period = list(t_period[:len(restarts) + 1])

    def lr_fn(step) -> float:
        seg = sum(step >= b for b in restarts)
        return eta_min + (base_lr * seg_weight[seg] - eta_min) * (
            1 + math.cos(math.pi * (step - seg_start[seg])
                         / seg_period[seg])) / 2.0

    return lr_fn


def multistep_restart(base_lr: float, milestones, restarts=None, weights=None,
                      gamma: float = 0.1):
    """MultiStepLR_Restart (lr_scheduler.py:8-32) in closed form: the LR at
    step t is base * weight(segment of t) * gamma^(#milestones in
    (segment start, t])."""
    restarts = [v + 1 for v in (restarts or [])]
    weights = list(weights or [])
    if restarts == [1]:  # the reference default restarts=[0], shifted
        restarts, weights = [], []
    if len(restarts) != len(weights):
        raise ValueError("restarts and weights must match")
    ms = Counter(milestones)

    def lr_fn(step) -> float:
        t = int(step)
        seg = bisect_right(restarts, t)
        start = 0 if seg == 0 else restarts[seg - 1]
        w = 1.0 if seg == 0 else weights[seg - 1]
        n = sum(c for m, c in ms.items() if start < m <= t)
        return base_lr * w * gamma ** n

    return lr_fn


def with_warmup(lr_fn, base_lr: float, warmup_iter: int = -1):
    """Linear warmup override for step < warmup_iter (base_model.py:52-64)."""
    if warmup_iter <= 0:
        return lr_fn
    return lambda step: (base_lr * step / warmup_iter if step < warmup_iter
                         else lr_fn(step))


def build_lr_schedule(train_opt: dict):
    """The step → lr function of a reference-format train config."""
    base_lr = float(train_opt["lr_G"])
    scheme = train_opt.get("lr_scheme", "MultiStepLR")
    if scheme == "CosineAnnealingLR_Restart":
        fn = cosine_annealing_restart(
            base_lr, train_opt["T_period"], train_opt.get("restarts") or [],
            train_opt.get("restart_weights") or [],
            float(train_opt.get("eta_min") or 0.0))
    elif scheme in ("MultiStepLR", "MultiStepLR_Restart"):
        raw = multistep_restart(
            base_lr, train_opt.get("lr_steps") or [],
            train_opt.get("restarts") or [],
            train_opt.get("restart_weights") or [],
            float(train_opt.get("lr_gamma") or 0.1))
        niter = int(train_opt["niter"])

        def fn(step):  # the JAX package's table lookup clips to [0, niter]
            return raw(min(max(int(step), 0), niter))
    else:
        raise NotImplementedError(f"lr scheme {scheme} not supported")
    return with_warmup(fn, base_lr, int(train_opt.get("warmup_iter") or -1))


def lr_scheduler(optimizer: torch.optim.Optimizer, train_opt: dict
                 ) -> torch.optim.lr_scheduler.LambdaLR:
    """LambdaLR giving update ``count`` (0-based) the LR of step count + 1.
    The optimizer's initial LR must be ``lr_G``."""
    fn = build_lr_schedule(train_opt)
    base_lr = float(train_opt["lr_G"])
    return torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: fn(count + 1) / base_lr)
