"""Train state and optimizer construction.

Counterpart of ``realvsr_tpu/train/state.py`` (the reference's BaseModel
optimizer/scheduler plumbing, ``codes/models/base_model.py``,
``VideoSR_..._Split.py:89-151``): Adam with the config's betas and optax's
default eps 1e-8 (AdamW when ``weight_decay_G`` is set: optax's ``adamw``
decays decoupled from the gradient, as torch's AdamW does), driven by the
closed-form LR schedule through ``LambdaLR`` at ``count + 1``.
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


def build_optimizer(params, train_opt: dict):
    """(optimizer, scheduler) from a reference-format train config."""
    if int(train_opt.get("ft_tsa_only") or 0):
        raise NotImplementedError(
            "ft_tsa_only freezes all but the TSA fusion, which is not ported "
            "yet (ROADMAP, queue 1, item 3)")
    lr = float(train_opt["lr_G"])
    betas = (float(train_opt.get("beta1") or 0.9),
             float(train_opt.get("beta2") or 0.99))
    wd = float(train_opt.get("weight_decay_G") or 0.0)
    if wd:
        opt = torch.optim.AdamW(params, lr=lr, betas=betas, eps=1e-8,
                                weight_decay=wd)
    else:
        opt = torch.optim.Adam(params, lr=lr, betas=betas, eps=1e-8)
    return opt, lr_scheduler(opt, train_opt)


def create_train_state(model: torch.nn.Module, opt: dict) -> TrainState:
    return TrainState(model, *build_optimizer(model.parameters(),
                                              opt["train"]))
