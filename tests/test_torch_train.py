"""The port's training slice on the CPU: one Split train step against the
JAX package's (loss, gradients, parameters after one Adam step), the
trainer command line end to end (validation, checkpoints, resume, loading
the result for inference), the augmentations, the data pipeline and the
mixed-precision contract of the model.

Inputs come from numpy seeds as float32; tolerances are stated per test.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu.train.state import TrainState as JaxTrainState
from realvsr_tpu.train.state import build_optimizer as jax_optimizer
from realvsr_tpu.train.wrappers import (
    make_split_train_step as jax_split_step)
from realvsr_tpu.losses import get_pixel_criterion as jax_criterion
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.data import create_dataset
from realvsr_tpu_torch.data.augments import _cutblur, apply_augment
from realvsr_tpu_torch.data.loader import TrainLoader
from realvsr_tpu_torch.models.edvr import EDVRNoUp
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.wrappers import (make_split_train_step,
                                              make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1, back_RBs=1,
           w_TSA=False)
R = 4


def _recipe():
    with open(os.path.join(REPO, "configs", "train",
                           "train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")  # the augmentations draw from different generators
    return opt


@pytest.fixture(scope="module")
def split_setup():
    """JAX params (offset convs randomised, so the sampling leaves the grid
    and the ±R clamp cuts some offsets) and a 64x64 batch of 2.  The frames
    are smooth (bicubic from 8x8) as images are: on white noise the lappyr
    criterion's SSIM of the 16x16 base level is a difference of nearly
    equal f32 sums, and both packages lose three digits there."""
    rng = np.random.default_rng(2)
    lq = np.stack([cv2.resize(rng.random((8, 8, 3)).astype(np.float32),
                              (64, 64), interpolation=cv2.INTER_CUBIC)
                   for _ in range(6)]).reshape(2, 3, 64, 64, 3)
    lq = np.clip(lq + rng.normal(size=lq.shape) * 0.02, 0, 1).astype(
        np.float32)
    gt = np.clip(lq + rng.normal(size=lq.shape) * 0.05, 0, 1).astype(
        np.float32)
    jmodel = JaxEDVRNoUp(**NET)
    opt = _recipe()
    params = jax.tree.map(np.asarray, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(lq))["params"]))
    for lvl in ("L3", "L2", "L1", "cas"):
        c = params["pcd_align"][f"{lvl}_dcnpack"]["conv_offset_mask"]["Conv_0"]
        for name in ("kernel", "bias"):
            c[name] = (rng.normal(size=c[name].shape) * 1.5).astype(
                np.float32)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                  tx=jax_optimizer(opt["train"]))
    return opt, jmodel, jstate, lq, gt


def _jax_step(opt, jmodel, jstate, lq, gt):
    """(loss, grads, params after the step) of the JAX Split step."""
    t = opt["train"]
    cri_y = jax_criterion(t["pixel_criterion_y"])
    cri_c = jax_criterion(t["pixel_criterion_c"])
    gt_c = jnp.asarray(gt[:, 1])

    def loss_fn(params):
        pred = jmodel.apply({"params": params}, jnp.asarray(lq))
        return (cri_y(pred[..., 0:1], gt_c[..., 0:1])
                + cri_c(pred[..., 1:3], gt_c[..., 1:3]))

    grads = jax.jit(jax.grad(loss_fn))(jstate.params)
    new_state, logs = jax.jit(jax_split_step(jmodel, opt))(
        jstate, {"LQs": jnp.asarray(lq), "GT": jnp.asarray(gt)},
        jax.random.PRNGKey(1))
    return (float(logs["l_pix"]), state_dict_from_jax(jax.device_get(grads)),
            state_dict_from_jax(jax.device_get(new_state.params)))


@pytest.mark.parametrize("impl", ["exact", "block"])
def test_split_step_matches_jax(split_setup, impl):
    """Loss, every gradient and every parameter after one Adam step, against
    the JAX step with the exact DCN (stock XLA) and with the clamped block
    DCN at ±R (the port at ``dcn_max_offset=R``).  Gradients to 1e-4 of
    each tensor's largest (f32 through ~25 layers in other orders).  The
    block path forms its positions relative to each block's window, so they
    round differently in the last bit: a sample within an ulp of a pixel
    boundary would take the other one-sided difference there and move its
    offset's gradient by a whole pixel difference.  The fixture's data have
    no such sample (seeds 0 and 1 of the stream each have one, 1.2e-3 and
    2.4e-4 of the largest gradient of the conv feeding it).
    Adam's first update is LR * g / (|g| + eps), so a gradient error d moves
    a parameter by up to LR * d / eps: parameters after the step are held to
    LR * (1e-4 + min(2, d / eps)) with d that gradient tolerance, plus 1e-6
    relative for the rounding of the update into the parameter."""
    opt, jmodel, jstate, lq, gt = split_setup
    if impl == "block":
        prev = jdc.set_default_impl("block", block_max_offset=R)
        try:
            loss, grads, after = _jax_step(opt, jmodel, jstate, lq, gt)
        finally:
            jdc.set_default_impl(*prev)
    else:
        loss, grads, after = _jax_step(opt, jmodel, jstate, lq, gt)

    model = EDVRNoUp(**NET, device="cpu",
                     dcn_max_offset=R if impl == "block" else None)
    model.load_state_dict(state_dict_from_jax(jstate.params), strict=True)
    state = create_train_state(model, opt)
    state, logs = make_split_train_step(model, opt)(
        state, {"LQs": torch.from_numpy(lq), "GT": torch.from_numpy(gt)},
        torch.Generator())
    assert logs["l_pix"].item() == pytest.approx(loss, rel=1e-4)
    assert state.step == 1
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    lr, eps = float(opt["train"]["lr_G"]), 1e-8
    for k, g in grads.items():
        tol = 1e-4 * max(g.abs().max().item(), 1e-12)
        torch.testing.assert_close(named[k].grad, g, rtol=0, atol=tol,
                                   msg=lambda m: f"grad {k}: {m}")
        torch.testing.assert_close(
            named[k].detach(), after[k], rtol=1e-6,
            atol=lr * (1e-4 + min(2.0, tol / eps)),
            msg=lambda m: f"param {k}: {m}")


def _write_clip(root, frames=3, size=32):
    rng = np.random.default_rng(3)
    sub = root / "LQ" / "000"
    sub.mkdir(parents=True)
    for t in range(frames):
        cv2.imwrite(str(sub / f"{t:05d}.png"),
                    rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
    return str(root / "LQ")


def test_trainer_cli_trains_validates_saves_and_resumes(tmp_path,
                                                        monkeypatch):
    """The debug config's 16 iterations on the CPU through the command
    line: validation and checkpoints at 8 and 16; the final weights load
    into the inference command line with strict=True; ``resume_state``
    resumes at the saved step."""
    from realvsr_tpu_torch.core import config
    from realvsr_tpu_torch.tools import _cli, test_wo_gt, train

    def parse(path, is_train=True):
        return config.parse(path, is_train=is_train, root=str(tmp_path))

    monkeypatch.setattr(train, "parse", parse)
    monkeypatch.setattr(_cli, "parse", parse)
    cfg = os.path.join(REPO, "configs", "train",
                       "debug_EDVR_woTSA_Split_synthetic.yml")
    state = train.main(["-opt", cfg, "--device", "cpu"])
    assert state.step == 16
    exp = tmp_path / "experiments" / "debug_EDVR_woTSA_Split_synthetic"
    assert sorted(os.listdir(exp / "models")) == [
        "16_G.pth", "8_G.pth", "latest_G.pth"]
    assert sorted(os.listdir(exp / "training_state")) == [
        "16.state", "8.state"]
    log = (exp / "train.log").read_text()
    assert log.count("# Validation # PSNR") == 2
    assert "iter:      16" in log

    with open(cfg) as f:
        opt = yaml.safe_load(f)
    test_opt = {
        "name": "load_trained", "model": opt["model"], "scale": 1,
        "network_G": opt["network_G"],
        "datasets": {"test": {"name": "t", "mode": "video_test",
                              "dataroot_LQ": _write_clip(tmp_path)}},
        "path": {"pretrain_model_G": str(exp / "models" / "latest_G.pth"),
                 "strict_load": True}}
    yml = tmp_path / "test.yml"
    yml.write_text(yaml.safe_dump(test_opt))
    res = test_wo_gt.main(["-opt", str(yml), "--device", "cpu"])
    assert res["n_frames"] == 3

    opt["path"]["resume_state"] = str(exp / "training_state" / "8.state")
    opt["train"]["niter"] = 10
    resume_yml = tmp_path / "resume.yml"
    resume_yml.write_text(yaml.safe_dump(opt))
    from realvsr_tpu_torch.train.trainer import Trainer

    trainer = Trainer(parse(str(resume_yml)), device="cpu",
                      dcn_max_offset=train.DCN_MAX_OFFSET)
    assert trainer.current_step == trainer.state.step == 8
    assert trainer.state.scheduler.last_epoch == 8
    sd = torch.load(exp / "models" / "8_G.pth", weights_only=True)
    for k, v in trainer.model.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
    assert trainer.train().step == 10


def test_cutblur_swaps_one_box_of_the_drawn_size():
    """GT is unchanged; LQ equals GT either inside or outside one box of
    floor(h * ratio) x floor(w * ratio), ratio ~ N(alpha, 0.01)."""
    rng = np.random.default_rng(4)
    gt = torch.from_numpy(rng.random((2, 3, 40, 48, 3)).astype(np.float32))
    lq = torch.from_numpy(rng.random((2, 3, 40, 48, 3)).astype(np.float32))
    seen_inside = set()
    for seed in range(12):
        g_aug, l_aug = _cutblur(torch.Generator().manual_seed(seed), gt, lq,
                                prob=1.0, alpha=0.7)
        assert torch.equal(g_aug, gt)
        same = (l_aug == gt).all(dim=(0, 1, 4))
        kept = (l_aug == lq).all(dim=(0, 1, 4))
        assert (same | kept).all()
        inside = same.sum() < kept.sum()
        box = same if inside else kept
        rows, cols = box.any(1).nonzero(), box.any(0).nonzero()
        hb, wb = len(rows), len(cols)
        assert box.sum() == hb * wb  # one rectangle
        assert rows.max() - rows.min() + 1 == hb
        assert abs(hb / 40 - 0.7) < 0.06 and abs(wb / 48 - 0.7) < 0.06
        seen_inside.add(bool(inside))
    assert seen_inside == {True, False}


def test_apply_augment_picks_by_mix_p():
    gt = torch.rand(2, 3, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    lq = torch.rand(2, 3, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    picks = []
    for _ in range(40):
        g, l = apply_augment(gen, gt, lq, ["none", "rgb"], [1.0, 1.0],
                             [1.0, 1.0], [0.5, 0.5])
        picks.append(not torch.equal(l, lq))
        if picks[-1]:  # a channel permutation of both
            perm = [int((l[..., c:c + 1] == lq).all(dim=(0, 1, 2, 3))
                        .nonzero()[0]) for c in range(3)]
            assert torch.equal(g, gt[..., perm])
    assert 5 < sum(picks) < 35
    with pytest.raises(ValueError, match="valid augmentation"):
        apply_augment(gen, gt, lq, ["mixup"], [1.0], [1.0])


class _Broken:
    def __len__(self):
        return 8

    def get(self, index, rng):
        if index == 5:
            raise OSError("unreadable frame")
        return {"LQs": np.zeros((3, 4, 4, 3), np.float32)}


def test_train_loader_raises_the_producers_failure():
    loader = TrainLoader(_Broken(), batch_size=2, ratio=1, num_workers=2)
    with pytest.raises(RuntimeError, match="loader failed") as info:
        for _ in loader.epoch_iter(0):
            pass
    assert isinstance(info.value.__cause__, OSError)


def test_train_loader_batches_are_seeded_and_complete():
    ds = create_dataset(dict(mode="Synthetic", phase="train", N_frames=3,
                             num_seqs=2, frames_per_seq=4, GT_size=32))
    loader = TrainLoader(ds, batch_size=4, ratio=2, num_workers=3, seed=1)
    a = list(loader.epoch_iter(0))
    b = list(loader.epoch_iter(0))
    assert len(a) == len(loader) == 4
    assert a[0]["LQs"].shape == (4, 3, 32, 32, 3)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x["GT"], y["GT"])
    # stopping early stops the producer
    it = loader.epoch_iter(1)
    next(it)
    it.close()


def test_unported_modes_name_the_roadmap():
    """What training still lacks, the GAN model and the Combine wrapper's
    VGG feature loss (both ROADMAP queue 1, item 4), raises naming it."""
    model = EDVRNoUp(**NET, device="cpu")
    opt = _recipe()
    with pytest.raises(NotImplementedError, match="ROADMAP, queue 1, item 4"):
        make_train_step(model, {**opt, "model": "VideoSR_GAN_YCbCr_Split"})
    combine = {**opt, "model": "VideoSR_AllPair_YCbCr_Combine",
               "train": {**opt["train"], "pixel_criterion": "cb",
                         "pixel_weight": 1.0, "feature_criterion": "l1",
                         "feature_weight": 0.1}}
    with pytest.raises(NotImplementedError, match="ROADMAP, queue 1, item 4"):
        make_train_step(model, combine)


def test_combine_step_and_adamw():
    opt = _recipe()
    opt["model"] = "VideoSR_AllPair_YCbCr_Combine"
    opt["train"].update(pixel_criterion="cb", pixel_weight=1.0,
                        edge_criterion="pyr", edge_weight=0.5,
                        weight_decay_G=0.01)
    model = EDVRNoUp(**NET, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, opt)
    assert isinstance(state.optimizer, torch.optim.AdamW)
    x = torch.rand(1, 3, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, logs = make_train_step(model, opt)(state, {"LQs": x, "GT": x},
                                              torch.Generator())
    assert set(logs) == {"l_pix", "l_edg", "l_tot"}
    assert logs["l_tot"].item() == pytest.approx(
        (logs["l_pix"] + logs["l_edg"]).item())
    assert any(not torch.equal(v, model.state_dict()[k])
               for k, v in before.items())


def test_bf16_model_keeps_f32_parameters_and_matches_a_cast_model():
    """``dtype`` is the compute dtype: f32 parameters cast at use give the
    same bf16 outputs as parameters cast once (as the inference slice did),
    and f32 gradients."""
    gen = torch.Generator().manual_seed(5)
    mixed = EDVRNoUp(**NET, device="cpu", dtype=torch.bfloat16, generator=gen)
    assert {p.dtype for p in mixed.parameters()} == {torch.float32}
    cast = EDVRNoUp(**NET, device="cpu", dtype=torch.bfloat16)
    cast.load_state_dict(mixed.state_dict())
    cast.to(torch.bfloat16)
    x = torch.rand(1, 3, 24, 32, 3, generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(mixed(x.bfloat16()), cast(x.bfloat16()),
                                   rtol=0, atol=0)
    out = mixed(x)
    assert out.dtype == torch.float32  # the f32 centre frame is added
    out.square().mean().backward()
    assert {p.grad.dtype for p in mixed.parameters()} == {torch.float32}
