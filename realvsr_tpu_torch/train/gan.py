"""The GAN-Split training step (the reference's
``codes/models/VideoSRGAN_AllPair_model_YCbCr_Split.py``).

Counterpart of ``realvsr_tpu/train/gan.py``, step for step.  Losses on
the Y channel's 3-level Laplacian pyramid: the structure loss on the LF
base, the detail loss on HF levels 0 and 1, the colour loss on CbCr, an
optional VGG feature loss on the LF base (1 channel, broadcast against
VGG's 3-channel ImageNet normalisation), and the adversarial term of a
multiscale discriminator on the two HF levels (gan, or ragan with
``pred_real`` detached).  Two Adam optimisers, G's and D's, each with its
own LR schedule.

As in JAX:

  * G's update is gated by ``D_update_ratio`` / ``D_init_iters`` (step i,
    1-based, updates G when i % ratio == 0 and i > init iters).  A gated
    step leaves G's optimizer and its schedule where they were (JAX's
    ``lax.cond`` keeps the optax state, count included); its losses are
    still computed and logged, and its backward is skipped (nothing reads
    it).
  * D's BatchNorms in G's step normalise with batch statistics and leave
    the running ones as they are (JAX applies D there without a mutable
    collection); D's parameters take no gradient from G's loss.
  * D's step forwards the real levels, then the fake ones (from G's
    output before G's update, detached), each moving the running
    statistics in turn; ragan detaches the other side's mean.
  * G's own BatchNorms (TOF-GAN's SpyNet) move their running statistics
    in G's forward, whether or not G updates.

Under a process group each rank steps on its rows of the global batch and
the step computes JAX's global-batch step: the BatchNorms take the global
batch's statistics (``models/common.py``), RaGAN's batch means are global
(``parallel/mesh.py::global_mean``, with its gradient in G's step, where
``pred_fake``'s mean is not detached, and detached in D's), and G's and
D's gradients are averaged over the ranks before each update (one flat
all-reduce each, as XLA inserts in JAX: a gated G step runs no backward and
no all-reduce on any rank).

``ref`` in a batch (else GT, before augmentation) is what D sees as real.
The prediction enters the losses in f32, as in the Split wrapper.
"""
from __future__ import annotations

from typing import Callable

import torch

from realvsr_tpu_torch.losses import (charbonnier_loss, gan_loss, gw_loss,
                                      huber_loss, l1_loss, l2_loss,
                                      ssim_loss)
from realvsr_tpu_torch.models.common import updating_batch_stats
from realvsr_tpu_torch.ops.pyramid import laplacian_pyramid
from realvsr_tpu_torch.parallel.mesh import average_gradients, global_mean
from realvsr_tpu_torch.train.state import build_optimizer
from realvsr_tpu_torch.train.wrappers import _maybe_augment

_CRITERIA = {
    "l1": l1_loss,
    "l2": l2_loss,
    "cb": charbonnier_loss,
    "hb": huber_loss,
    "gw": lambda x, y: gw_loss(x, y, w=4.0),
    "ssim": lambda x, y: ssim_loss(x, y),
}


class GANTrainState:
    """G and D, each with its optimizer and LR scheduler, and the step
    count (the JAX ``GANTrainState``; here updated in place)."""

    def __init__(self, model_g, model_d, optimizer_g, scheduler_g,
                 optimizer_d, scheduler_d):
        self.model, self.model_d = model_g, model_d
        self.optimizer_g, self.scheduler_g = optimizer_g, scheduler_g
        self.optimizer_d, self.scheduler_d = optimizer_d, scheduler_d
        self.step = 0

    @property
    def optimizers(self):
        return [self.optimizer_g, self.optimizer_d]

    @property
    def schedulers(self):
        return [self.scheduler_g, self.scheduler_d]


def _optimizer(model, train_opt: dict, which: str):
    """Adam (AdamW with a weight decay) of ``lr_{which}``, ``beta1_
    {which}``, ``beta2_{which}``, ``weight_decay_{which}`` on the config's
    schedule, as the JAX package's ``_make_tx``."""
    return build_optimizer(model.named_parameters(), dict(
        train_opt, lr_G=train_opt[f"lr_{which}"],
        beta1=train_opt.get(f"beta1_{which}"),
        beta2=train_opt.get(f"beta2_{which}"),
        weight_decay_G=train_opt.get(f"weight_decay_{which}"),
        ft_tsa_only=0))


def create_gan_train_state(model_g, model_d, opt: dict) -> GANTrainState:
    t = opt["train"]
    return GANTrainState(model_g, model_d, *_optimizer(model_g, t, "G"),
                         *_optimizer(model_d, t, "D"))


def make_gan_split_train_step(model_g, opt: dict,
                              feature_apply: Callable | None = None
                              ) -> Callable:
    """``train_step(state, batch, gen) -> (state, logs)`` on a
    :class:`GANTrainState`; ``feature_apply`` is the frozen VGG extractor
    when ``feature_criterion`` and ``feature_weight > 0`` are set."""
    train_opt = opt["train"]
    w_s = float(train_opt.get("pixel_weight_s") or 0.0)
    w_d = float(train_opt.get("pixel_weight_d") or 0.0)
    w_c = float(train_opt.get("pixel_weight_c") or 0.0)
    w_fea = float(train_opt.get("feature_weight") or 0.0)
    w_gan = float(train_opt.get("gan_weight") or 1e-4)
    cri_s = _CRITERIA[train_opt["pixel_criterion_s"]] if w_s > 0 else None
    cri_d = _CRITERIA[train_opt["pixel_criterion_d"]] if w_d > 0 else None
    cri_c = _CRITERIA[train_opt["pixel_criterion_c"]] if w_c > 0 else None
    cri_fea = _CRITERIA[train_opt["feature_criterion"]] if (
        w_fea > 0 and train_opt.get("feature_criterion")) else None
    if cri_fea is not None and feature_apply is None:
        raise ValueError("the feature loss needs a VGG feature extractor")
    gan_type = train_opt.get("gan_type") or "gan"
    base_type = "gan" if gan_type == "ragan" else gan_type
    d_update_ratio = int(train_opt.get("D_update_ratio") or 1)
    d_init_iters = int(train_opt.get("D_init_iters") or 0)

    def cri_gan(logits, is_real):
        return gan_loss(logits, is_real, gan_type=base_type)

    def train_step(state: GANTrainState, batch, gen):
        model_g, model_d = state.model, state.model_d
        ref = batch.get("ref", batch["GT"])
        gt, lq = _maybe_augment(opt, gen, batch["GT"], batch["LQs"])
        ctr = lq.shape[1] // 2
        real, real_ref = gt[:, ctr], ref[:, ctr]
        real_y_pyr = laplacian_pyramid(real[..., 0:1], max_levels=3)
        real_ref_y_pyr = laplacian_pyramid(real_ref[..., 0:1], max_levels=3)
        step_i = state.step + 1   # the reference counts steps from 1
        g_active = step_i % d_update_ratio == 0 and step_i > d_init_iters

        # ---------------------------- G step ----------------------------
        model_g.train()
        model_d.train()
        with updating_batch_stats(model_g):
            fake = model_g(lq).float()
        fake_y_pyr = laplacian_pyramid(fake[..., 0:1], max_levels=3)
        logs, total = {}, 0.0
        if cri_s:
            logs["l_g_pix_s"] = w_s * cri_s(fake_y_pyr[-1], real_y_pyr[-1])
            total = total + logs["l_g_pix_s"]
        if cri_d:
            logs["l_g_pix_d"] = (w_d * cri_d(fake_y_pyr[0], real_y_pyr[0])
                                 + w_d * cri_d(fake_y_pyr[1],
                                               real_y_pyr[1]))
            total = total + logs["l_g_pix_d"]
        if cri_c:
            logs["l_g_pix_c"] = w_c * cri_c(fake[..., 1:3], real[..., 1:3])
            total = total + logs["l_g_pix_c"]
        if cri_fea:
            with torch.no_grad():
                real_fea = feature_apply(real_y_pyr[-1])
            logs["l_g_fea"] = w_fea * cri_fea(feature_apply(fake_y_pyr[-1]),
                                              real_fea)
            total = total + logs["l_g_fea"]
        model_d.requires_grad_(False)
        try:
            if gan_type == "gan":
                l_gan = sum(w_gan * cri_gan(p, True)
                            for p in model_d(fake_y_pyr[:-1]))
            else:   # ragan
                with torch.no_grad():
                    pred_real = model_d(real_ref_y_pyr[:-1])
                pred_fake = model_d(fake_y_pyr[:-1])
                l_gan = sum(
                    w_gan * (cri_gan(pr - global_mean(pf), False)
                             + cri_gan(pf - global_mean(pr), True)) / 2.0
                    for pr, pf in zip(pred_real, pred_fake))
        finally:
            model_d.requires_grad_(True)
        logs["l_g_gan"] = l_gan
        logs["l_g_total"] = total + l_gan
        if g_active:
            state.optimizer_g.zero_grad(set_to_none=True)
            logs["l_g_total"].backward()
            average_gradients(model_g.parameters())
            state.optimizer_g.step()
            state.scheduler_g.step()

        # ---------------------------- D step ----------------------------
        fake_levels = [p.detach() for p in fake_y_pyr[:-1]]
        with updating_batch_stats(model_d):
            pred_real = model_d(real_ref_y_pyr[:-1])
            pred_fake = model_d(fake_levels)
        if gan_type == "gan":
            l_real = sum(cri_gan(p, True) for p in pred_real)
            l_fake = sum(cri_gan(p, False) for p in pred_fake)
        else:
            l_real = sum(cri_gan(pr - global_mean(pf.detach()), True) * 0.5
                         for pr, pf in zip(pred_real, pred_fake))
            l_fake = sum(cri_gan(pf - global_mean(pr.detach()), False) * 0.5
                         for pr, pf in zip(pred_real, pred_fake))
        state.optimizer_d.zero_grad(set_to_none=True)
        (l_real + l_fake).backward()
        average_gradients(model_d.parameters())
        state.optimizer_d.step()
        state.scheduler_d.step()
        state.step += 1

        logs.update(l_d_real=l_real, l_d_fake=l_fake)
        logs = {k: v.detach() for k, v in logs.items()}
        logs["g_active"] = torch.tensor(float(g_active))
        return state, logs

    return train_step
