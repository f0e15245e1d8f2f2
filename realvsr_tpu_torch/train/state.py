"""Train state and optimizer construction.

Counterpart of ``realvsr_tpu/train/state.py`` (the reference's BaseModel
optimizer/scheduler plumbing, ``codes/models/base_model.py``,
``VideoSR_..._Split.py:89-151``): Adam with the config's betas and optax's
default eps 1e-8 (AdamW when ``weight_decay_G`` is set: optax's ``adamw``
decays decoupled from the gradient, as torch's AdamW does), driven by the
closed-form LR schedule through ``LambdaLR`` at ``count + 1``.

``ft_tsa_only: N`` trains the TSA fusion alone at first, as the reference
does (``VideoSR_..._Split.py:160-165``): two parameter groups, every
parameter outside ``tsa_fusion`` in group 0 and the ``tsa_fusion`` ones in
group 1, and group 0's LR is zero for the updates at steps (1-based) below
N.  Adam's moments still take every gradient, as the JAX package's update
mask leaves them (``realvsr_tpu/train/state.py:30-55``); AdamW's decay is
multiplied by the same zero LR.
"""
from __future__ import annotations

import torch

from realvsr_tpu_torch.schedules import lr_scheduler


class TrainState:
    """The model, its optimizer and LR scheduler, and the update count
    (the JAX ``TrainState``; here updated in place)."""

    def __init__(self, model: torch.nn.Module, optimizer, scheduler):
        self.model = model
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.step = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the gradients in ``.grad``, then the
        LR of the next update."""
        self.optimizer.step()
        self.scheduler.step()
        self.step += 1


def build_optimizer(named_params, train_opt: dict):
    """(optimizer, scheduler) from a reference-format train config, over
    ``named_params`` ((name, parameter) pairs, e.g.
    ``model.named_parameters()``)."""
    lr = float(train_opt["lr_G"])
    betas = (float(train_opt.get("beta1") or 0.9),
             float(train_opt.get("beta2") or 0.99))
    wd = float(train_opt.get("weight_decay_G") or 0.0)
    named = list(named_params)
    ft_tsa_only = int(train_opt.get("ft_tsa_only") or 0)
    if ft_tsa_only:
        groups = [{"params": [p for k, p in named if "tsa_fusion" not in k]},
                  {"params": [p for k, p in named if "tsa_fusion" in k]}]
    else:
        groups = [{"params": [p for _, p in named]}]
    if wd:
        opt = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=wd)
    else:
        opt = torch.optim.Adam(groups, lr=lr, betas=betas, eps=1e-8)
    return opt, lr_scheduler(opt, train_opt, group0_frozen_until=ft_tsa_only)


def create_train_state(model: torch.nn.Module, opt: dict) -> TrainState:
    return TrainState(model, *build_optimizer(model.named_parameters(),
                                              opt["train"]))
