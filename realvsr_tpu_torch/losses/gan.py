"""GAN losses: the vanilla / lsgan / wgan-gp objectives and the WGAN-GP
gradient penalty.

Counterpart of ``realvsr_tpu/losses/gan.py`` (the reference's
``loss.py:102-157``); ``ragan`` is the vanilla objective on relativistic
logits, which the GAN step forms.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def gan_loss(logits: torch.Tensor, target_is_real: bool,
             gan_type: str = "gan", real_label_val: float = 1.0,
             fake_label_val: float = 0.0) -> torch.Tensor:
    """The D / G objective on discriminator logits (loss.py:102-133)."""
    gan_type = gan_type.lower()
    label = real_label_val if target_is_real else fake_label_val
    if gan_type in ("gan", "ragan"):
        return F.binary_cross_entropy_with_logits(
            logits, torch.full_like(logits, label))
    if gan_type == "lsgan":
        return torch.mean((logits - label) ** 2)
    if gan_type == "wgan-gp":
        return -torch.mean(logits) if target_is_real else torch.mean(logits)
    raise NotImplementedError(f"GAN type [{gan_type}] is not found")


def gradient_penalty(d_apply: Callable[[torch.Tensor], torch.Tensor],
                     interp: torch.Tensor) -> torch.Tensor:
    """WGAN-GP penalty (loss.py:136-157): the mean of (||dD/dx||_2 - 1)^2
    over the samples of ``interp``, differentiable (the gradient is taken
    with ``create_graph=True``)."""
    if not interp.requires_grad:
        interp = interp.detach().requires_grad_(True)
    grads, = torch.autograd.grad(d_apply(interp).sum(), interp,
                                 create_graph=True)
    g = grads.reshape(grads.shape[0], -1)
    norm = torch.sqrt(torch.sum(g ** 2, dim=1) + 1e-12)
    return torch.mean((norm - 1.0) ** 2)
