"""Loss-assembly train steps of the model wrappers.

Counterparts of ``realvsr_tpu/train/wrappers.py``, rebuilding the
reference's training logic:

  * Split — separate Y / CbCr criteria on the YCbCr channels
    (``VideoSR_AllPair_model_YCbCr_Split.py:163-191``),
  * Combine — one criterion on all channels plus an optional edge loss
    and VGG feature loss (``VideoSR_AllPair_model_YCbCr_Combine.py:
    190-215``),
  * GAN-Split — in ``train/gan.py``; :func:`make_train_step` dispatches
    ``*GAN*`` models there.

Models forward as the JAX package's ``_forward_train`` applies them: in
train mode, a model with BatchNorm (TOF's SpyNet) moving its running
statistics (``updating_batch_stats``); a BN-free model as it is applied
at inference, so FSTRN trains without its dropout (``models/fstrn.py``).

Each ``make_*_train_step`` returns ``train_step(state, batch, gen) ->
(state, logs)``: augment, forward, loss, backward and one optimizer update
of the :class:`~realvsr_tpu_torch.train.state.TrainState` (in place), each
a span of :mod:`~realvsr_tpu_torch.utils.trace` (``train.augment``,
``train.forward``, ``train.loss``, ``train.backward`` with the gradients'
average, ``train.optimizer``).  Batches are
``{'LQs': (B, T, H, W, C), 'GT': (B, T, H, W, C)}`` tensors on the model's
device (AllPair layout; the loss takes the centre frame); ``gen`` is the
augmentations' generator on that device.  ``logs`` are 0-d tensors, read
on the host only when printed.  The losses take the prediction in f32: a
model that ends in its compute dtype (TDAN in bf16) is cast up exactly, as
JAX promotes bf16 against the f32 GT.

Under a process group the batch is the rank's rows of the global batch:
the gradients are averaged over the ranks before the update
(``parallel/mesh.py::average_gradients``; every loss is a batch mean), so
every rank takes JAX's global-batch update.
"""
from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from realvsr_tpu_torch.data.augments import apply_augment
from realvsr_tpu_torch.losses import get_pixel_criterion, pyramid_loss
from realvsr_tpu_torch.models.common import updating_batch_stats
from realvsr_tpu_torch.parallel.mesh import average_gradients
from realvsr_tpu_torch.utils import trace


def _maybe_augment(opt: dict, gen, gt, lq):
    aug = opt.get("augment") if opt else None
    if not aug:
        return gt, lq
    return apply_augment(gen, gt, lq, aug["augs"], aug["probs"],
                         aug["alphas"], aug["mix_p"])


def _forward_train(model, lq: torch.Tensor) -> torch.Tensor:
    """The training forward (JAX's ``_forward_train``), in f32 (f64 for a
    float64 model, as the parity tests run one)."""
    model.train()
    with updating_batch_stats(model):
        pred = model(lq)
        return pred.to(torch.promote_types(pred.dtype, torch.float32))


def _update(state, loss: torch.Tensor) -> None:
    with trace.span("train.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        average_gradients(state.model.parameters())
    with trace.span("train.optimizer"):
        state.apply_gradients()


def make_split_train_step(model, opt: dict) -> Callable:
    """YCbCr Split: w_y * cri_y(pred_Y, gt_Y) + w_c * cri_c(pred_C, gt_C)."""
    train_opt = opt["train"]
    cri_y = get_pixel_criterion(train_opt["pixel_criterion_y"])
    cri_c = get_pixel_criterion(train_opt["pixel_criterion_c"])
    w_y = float(train_opt["pixel_weight_y"])
    w_c = float(train_opt["pixel_weight_c"])

    def train_step(state, batch, gen):
        with trace.span("train.augment"):
            gt, lq = _maybe_augment(opt, gen, batch["GT"], batch["LQs"])
            gt_c = gt[:, lq.shape[1] // 2]
        with trace.span("train.forward"):
            pred = _forward_train(state.model, lq)
        with trace.span("train.loss"):
            l_y = w_y * cri_y(pred[..., 0:1], gt_c[..., 0:1])
            l_c = w_c * cri_c(pred[..., 1:3], gt_c[..., 1:3])
            l_pix = l_y + l_c
        _update(state, l_pix)
        return state, {"l_pix_y": l_y.detach(), "l_pix_c": l_c.detach(),
                       "l_pix": l_pix.detach()}

    return train_step


def make_combine_train_step(model, opt: dict,
                            feature_apply: Callable | None = None
                            ) -> Callable:
    """YCbCr Combine: one criterion on all channels (+ edge, + VGG
    feature).  ``feature_apply(x) -> features`` is the frozen VGG
    extractor when ``feature_criterion`` and ``feature_weight`` are set:
    it takes the f32 prediction and the GT (the latter without a
    gradient)."""
    train_opt = opt["train"]
    cri_fea = None
    if train_opt.get("feature_criterion") and train_opt.get("feature_weight"):
        if feature_apply is None:
            raise ValueError("the feature loss needs a VGG feature "
                             "extractor")
        cri_fea = get_pixel_criterion(train_opt["feature_criterion"])
        w_fea = float(train_opt["feature_weight"])
    cri_pix = get_pixel_criterion(train_opt["pixel_criterion"])
    w_pix = float(train_opt["pixel_weight"])
    cri_edg = None
    if train_opt.get("edge_criterion") and train_opt.get("edge_weight"):
        name = train_opt["edge_criterion"]
        # the Combine wrapper's 'pyr' edge loss is the laplacian pyramid
        # (VideoSR_..._Combine.py:75-76)
        cri_edg = (partial(pyramid_loss, num_levels=3, pyr_mode="lap",
                           loss_mode="cb") if name == "pyr"
                   else get_pixel_criterion(name))
        w_edg = float(train_opt["edge_weight"])

    def train_step(state, batch, gen):
        with trace.span("train.augment"):
            gt, lq = _maybe_augment(opt, gen, batch["GT"], batch["LQs"])
            gt_c = gt[:, lq.shape[1] // 2]
        with trace.span("train.forward"):
            pred = _forward_train(state.model, lq)
        with trace.span("train.loss"):
            l_pix = w_pix * cri_pix(pred, gt_c)
            logs = {"l_pix": l_pix.detach()}
            l_tot = l_pix
            if cri_edg is not None:
                l_edg = w_edg * cri_edg(pred, gt_c)
                logs["l_edg"] = l_edg.detach()
                l_tot = l_tot + l_edg
            if cri_fea is not None:
                with torch.no_grad():
                    real_fea = feature_apply(gt_c)
                l_fea = w_fea * cri_fea(feature_apply(pred), real_fea)
                logs["l_fea"] = l_fea.detach()
                l_tot = l_tot + l_fea
            logs["l_tot"] = l_tot.detach()
        _update(state, l_tot)
        return state, logs

    return train_step


def make_eval_step(model) -> Callable:
    """Forward for validation (the wrapper's ``.test()``), in eval mode."""

    @torch.inference_mode()
    def eval_step(lq: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(lq)

    return eval_step


def make_train_step(model, opt: dict,
                    feature_apply: Callable | None = None) -> Callable:
    """Dispatch on opt['model'] as the reference's create_model
    (models/__init__.py:5-17) and the JAX package do: ``*GAN*`` to the
    GAN-Split step (its state a ``train.gan.GANTrainState``), Split,
    then Combine (and the bare ``VideoSR_AllPair`` of the Vimeo90K
    configs, which carry one combined criterion)."""
    name = opt["model"]
    if "GAN" in name:
        from realvsr_tpu_torch.train.gan import make_gan_split_train_step

        return make_gan_split_train_step(model, opt, feature_apply)
    if "Split" in name:
        return make_split_train_step(model, opt)
    if "Combine" in name or name == "VideoSR_AllPair":
        return make_combine_train_step(model, opt, feature_apply)
    raise NotImplementedError(f"Model [{name}] not recognized.")
