"""Training TDAN and EDVR x4 + TSA in the port, against the JAX package on
the CPU: TDAN's Split step (loss, every gradient, every parameter after
Adam; the helpers hold EDVR x4 + TSA's and its ``ft_tsa_only`` steps in
``test_torch_train_tsa.py``), the training command line end to end on
shrunk copies of the two motion smoke configs (validation at x4
included), a Trainer built from each motion config and recipe, and the x4
recipe's cutblur.

Batches are motion-synthetic items (the port's dataset, numpy float32 from
seeds, equal to the JAX package's: ``test_torch_motion_data.py``); JAX
params come from ``init`` with the zero-initialised DCN offset convs
randomised, and move to the port through ``state_dict_from_jax``.
"""
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.losses import get_pixel_criterion as jax_criterion
from realvsr_tpu.models import define_g as jax_define_g
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu.train.state import TrainState as JaxTrainState
from realvsr_tpu.train.state import build_optimizer as jax_optimizer
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.data import create_dataset
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.wrappers import make_split_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R = 4
# the recipe's lappyr criterion takes an SSIM of the 1/4-size base level
# with an 11-tap window, so GT crops are at least 44 px: TDAN (scale 1) runs
# at 48x48, EDVR x4 at LQ 16x16 (GT 64x64)
FAMILIES = {  # name: (network_G, scale, LQ side)
    "tdan": (dict(which_model_G="TDAN", nf=64, nc=3, nframes=3, nb_f=1,
                  nb_b=1, groups=8), 1, 48),
    "edvr_x4_tsa": (dict(which_model_G="EDVR", nf=16, nc=3, nframes=5,
                         groups=4, front_RBs=1, back_RBs=1, center=None,
                         predeblur=False, HR_in=False, w_TSA=True), 4, 16),
}


def _opt(name, ft_tsa_only=0):
    """The Split recipe's train options (its losses, Adam, schedule) around
    the family's network; no augmentation (the packages draw it from
    different generators)."""
    with open(os.path.join(REPO, "configs", "train",
                           "train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")
    net, scale, _ = FAMILIES[name]
    opt["network_G"], opt["scale"] = dict(net), scale
    opt["train"]["ft_tsa_only"] = ft_tsa_only
    return opt


def _randomise_offset_convs(tree, rng, std):
    """Every ``conv_offset_mask`` conv of a flax param tree, in place."""
    for k, v in tree.items():
        if k == "conv_offset_mask":
            for leaf in ("kernel", "bias"):
                c = v["Conv_0"]
                c[leaf] = (rng.normal(size=c[leaf].shape) * std).astype(
                    np.float32)
        elif isinstance(v, dict):
            _randomise_offset_convs(v, rng, std)


def _batch(name, items=(3, 8)):
    """Motion-synthetic AllPair batch of 2: LQ at the family's side, GT at
    scale times it."""
    net, scale, side = FAMILIES[name]
    ds = create_dataset(dict(
        mode="SyntheticMotion", phase="train", N_frames=net["nframes"],
        GT_size=side * scale, scale=scale, num_seqs=2, frames_per_seq=6,
        frame_h=side * scale + 16, frame_w=side * scale + 16))
    got = [ds.get(i, np.random.default_rng(i)) for i in items]
    return {k: np.stack([g[k] for g in got]) for k in ("LQs", "GT")}


def setup_family(name):
    """(name, JAX model, JAX params with the offset convs randomised, a
    motion batch, the JAX exact step's (losses, grads, params after))."""
    batch = _batch(name)
    jmodel = jax_define_g(_opt(name))
    params = jax.tree.map(np.asarray, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["LQs"]))["params"]))
    _randomise_offset_convs(params, np.random.default_rng(1), std=0.5)
    exact = _jax_steps(_opt(name), jmodel, params, batch, 1)
    return name, jmodel, params, batch, exact


@pytest.fixture(scope="module")
def tdan():
    return setup_family("tdan")


def _jax_steps(opt, jmodel, params, batch, n):
    """``n`` JAX Split steps as ``realvsr_tpu.train.wrappers.
    make_split_train_step`` takes them (its loss through
    ``jax.value_and_grad``, then ``state.apply_gradients``), with no
    augmentation: (losses, grads of the first step, params after each
    step)."""
    t = opt["train"]
    cri_y, cri_c = (jax_criterion(t["pixel_criterion_y"]),
                    jax_criterion(t["pixel_criterion_c"]))
    lq = jnp.asarray(batch["LQs"])
    gt_c = jnp.asarray(batch["GT"][:, batch["LQs"].shape[1] // 2])

    def loss_fn(p):
        pred = jmodel.apply({"params": p}, lq)
        return (cri_y(pred[..., 0:1], gt_c[..., 0:1])
                + cri_c(pred[..., 1:3], gt_c[..., 1:3]))

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    update = jax.jit(lambda state, g: state.apply_gradients(grads=g))
    state = JaxTrainState.create(apply_fn=jmodel.apply, params=params,
                                 tx=jax_optimizer(t))
    losses, grads, after = [], None, []
    for _ in range(n):
        loss, g = value_and_grad(state.params)
        grads = grads or state_dict_from_jax(jax.device_get(g))
        state = update(state, g)
        losses.append(float(loss))
        after.append(state_dict_from_jax(jax.device_get(state.params)))
    return losses, grads, after


def _port(opt, params, r):
    model = define_g(opt, device="cpu", dcn_max_offset=r)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model, create_train_state(model, opt)


def _port_step(model, state, opt, batch):
    _, logs = make_split_train_step(model, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator())
    return logs["l_pix"].item()


def _close_params(named, ref, atol):
    for k, v in ref.items():
        torch.testing.assert_close(named[k].detach(), v, rtol=1e-6,
                                   atol=atol, msg=lambda m: f"{k}: {m}")


# The gradients of the DCN offset chains (the offset convs and each DCN's
# conv_offset_mask: through the derivative of bilinear sampling by the
# position, differences of neighbouring pixels summed with cancellation)
# carry JAX's f32 rounding: against a float64 run of the port, JAX's f32
# step is up to 2.9e-4 of the tensor's largest there (TDAN's second DCN,
# EDVR's L1 DCN at ±R), the port's f32 step within 1e-5.
OFFSET_GRAD_REL = 5e-4


def hold_split_step(family, impl):
    """One Split step: the loss to 1e-4 relative, each gradient to 1e-4 of
    its tensor's largest magnitude (the DCN offset chains' to
    :data:`OFFSET_GRAD_REL`), each parameter after Adam to LR * (1e-4
    + min(2, tol / eps)) (Adam's first update is LR * g / (|g| + eps), so a
    gradient error d moves a parameter by up to LR * d / eps), as
    ``test_torch_train.py`` holds the flagship's step.

    ``block`` runs JAX through its ±R block DCN and the port at
    ``dcn_max_offset`` = R.  The block path forms its positions relative to
    each block's window, so they round differently in the last bit; a
    gradient reached only through a max pool (TSA's ``sAtt_1``, whose
    largest is 4e-6 of the model's) can then take another route.  Each
    gradient's bound there adds how far the JAX package's own exact step
    lies from its block step on that tensor (2.4e-3 of ``sAtt_1``'s
    largest; at most 2e-4 elsewhere)."""
    name, jmodel, params, batch, (losses, grads, after) = family
    opt = _opt(name)
    spread = {k: torch.zeros(()) for k in grads}
    if impl == "block":
        exact = grads
        prev = jdc.set_default_impl("block", block_max_offset=R)
        try:
            losses, grads, after = _jax_steps(opt, jmodel, params, batch, 1)
        finally:
            jdc.set_default_impl(*prev)
        spread = {k: (g - exact[k]).abs().max() for k, g in grads.items()}
    model, state = _port(opt, params, R if impl == "block" else None)
    loss = _port_step(model, state, opt, batch)
    assert loss == pytest.approx(losses[0], rel=1e-4)
    assert state.step == 1
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    lr, eps = float(opt["train"]["lr_G"]), 1e-8
    for k, g in grads.items():
        rel = OFFSET_GRAD_REL if "offset" in k else 1e-4
        tol = rel * max(g.abs().max().item(), 1e-12) + spread[k].item()
        torch.testing.assert_close(named[k].grad, g, rtol=0, atol=tol,
                                   msg=lambda m: f"grad {k}: {m}")
        torch.testing.assert_close(
            named[k].detach(), after[0][k], rtol=1e-6,
            atol=lr * (1e-4 + min(2.0, tol / eps)),
            msg=lambda m: f"param {k}: {m}")
    # the DCN offsets matter: every offset conv got a gradient
    assert all(named[k].grad.abs().max() > 0 for k in named
               if "conv_offset_mask" in k)


@pytest.mark.parametrize("impl", ["exact", "block"])
def test_split_step_matches_jax(tdan, impl):
    """TDAN's Split step against JAX's (:func:`hold_split_step`); EDVR x4
    + TSA's is in ``test_torch_train_tsa.py``."""
    hold_split_step(tdan, impl)


SMOKE = {  # config: (shrunk network_G, train crop, frame, val frame)
    "smoke_TDAN_motion.yml": (dict(nb_f=1, nb_b=1), 48, 64, 32),
    "smoke_EDVRx4_motion.yml": (dict(front_RBs=1, back_RBs=1), 64, 80, 32),
}


@pytest.mark.parametrize("cfg", list(SMOKE))
def test_train_cli_runs_the_motion_smoke_configs(cfg, tmp_path, monkeypatch):
    """A shrunk copy of each smoke config (depth 1, small crops, batch 1,
    2 iterations) through ``tools/train --device cpu``: both steps logged
    with finite losses, validation at the end on ``SyntheticMotionTest``
    (x4 for EDVR: LQ at 1/4, PSNR on the x4 output) finite, checkpoints
    written and loadable with strict=True."""
    from realvsr_tpu_torch.core import config
    from realvsr_tpu_torch.tools import train

    net, crop, frame, val = SMOKE[cfg]
    with open(os.path.join(REPO, "configs", "train", cfg)) as f:
        opt = yaml.safe_load(f)
    opt["network_G"].update(net)
    opt["datasets"]["train"].update(
        GT_size=crop, frame_h=frame, frame_w=frame, batch_size=1,
        n_workers=2, num_seqs=2, frames_per_seq=4, dataset_ratio=2)
    opt["datasets"]["val"].update(frame_h=val, frame_w=val)
    opt["train"].update(niter=2, T_period=[2], val_freq=2)
    opt["logger"].update(print_freq=1, save_checkpoint_freq=2)
    yml = tmp_path / cfg
    yml.write_text(yaml.safe_dump(opt))
    monkeypatch.setattr(train, "parse", lambda path, is_train=True: (
        config.parse(path, is_train=is_train, root=str(tmp_path))))
    trainer_state = train.main(["-opt", str(yml), "--device", "cpu"])
    assert trainer_state.step == 2
    exp = tmp_path / "experiments" / opt["name"]
    log = (exp / "train.log").read_text()
    iters = [ln for ln in log.splitlines() if " l_pix: " in ln]
    assert len(iters) == 2
    for ln in iters:
        vals = [float(ln.split(f"{k}: ")[1].split()[0])
                for k in ("l_pix_y", "l_pix_c", "l_pix")]
        assert all(math.isfinite(v) for v in vals)
    psnr = [float(ln.split("PSNR: ")[1].rstrip("."))
            for ln in log.splitlines() if "# Validation # PSNR" in ln]
    assert len(psnr) == 1 and math.isfinite(psnr[0]) and psnr[0] > 5
    assert sorted(os.listdir(exp / "models")) == ["2_G.pth", "latest_G.pth"]
    model = define_g(config.parse(str(yml), root=str(tmp_path)),
                     device="cpu")
    model.load_state_dict(torch.load(exp / "models" / "latest_G.pth",
                                     weights_only=True), strict=True)
    scale = opt["scale"]
    n = opt["network_G"]["nframes"]
    with torch.inference_mode():
        out = model(torch.rand(1, n, 8, 8, 3))
    assert out.shape == (1, 8 * scale, 8 * scale, 3)


def test_cutblur_at_x4_raises_as_the_jax_package_fails():
    """The x4 Vimeo90K recipe's augmentation names cutblur, which swaps
    patches between GT and LQ of one size: at x4 the port raises a
    ValueError naming it (the reference raises too), where the JAX package
    fails to broadcast."""
    from realvsr_tpu.data.augments import apply_augment as jax_augment
    from realvsr_tpu_torch.data.augments import apply_augment

    with open(os.path.join(REPO, "configs", "train",
                           "train_EDVRx4_TSA_Vimeo90K.yml")) as f:
        aug = yaml.safe_load(f)["augment"]
    assert "cutblur" in aug["augs"]
    gt = np.zeros((1, 3, 64, 64, 3), np.float32)
    lq = np.zeros((1, 3, 16, 16, 3), np.float32)
    with pytest.raises(ValueError, match="one size"):
        apply_augment(torch.Generator(), torch.from_numpy(gt),
                      torch.from_numpy(lq), aug["augs"], aug["probs"],
                      aug["alphas"], aug["mix_p"])
    with pytest.raises(ValueError, match="broadcast"):
        jax_augment(jax.random.PRNGKey(0), jnp.asarray(gt), jnp.asarray(lq),
                    aug["augs"], aug["probs"], aug["alphas"], aug["mix_p"])


# config: (generator, iterations an epoch = keys x dataset_ratio / batch,
# validation windows)
BUILDS = {
    "smoke_TDAN_motion.yml": ("TDAN", 640, 4),
    "smoke_EDVRx4_motion.yml": ("EDVR", 1280, 6),
    "bf16_vs_f32_motion.yml": ("EDVRNoUp", 1920, 12),
    "clamp_validation_motion.yml": ("EDVRNoUp", 1920, None),
    "bf16_vs_f32_cpu_mini.yml": ("EDVRNoUp", 768, None),
    "train_TDAN_RealVSR_YCbCr_Split.yml": ("TDAN", 140625, 0),
    "train_EDVRx4_TSA_Vimeo90K.yml": ("EDVR", 625, 0),
}


@pytest.mark.parametrize("cfg", list(BUILDS))
def test_trainer_builds_each_motion_and_recipe_config(cfg, tmp_path):
    """Every motion config and the TDAN / EDVR x4 recipes build their
    Trainer as parsed (datasets, generator, optimizer) on the CPU.  The
    recipes' frames are not in the repo: the RealVSR keys are, and the
    Vimeo90K keys pickle is written here (its key list comes with the
    dataset); their validation folders are absent, so no window."""
    import pickle

    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train.trainer import Trainer

    opt = parse(os.path.join(REPO, "configs", "train", cfg),
                root=str(tmp_path))
    if cfg.startswith("train_EDVRx4"):
        keys = tmp_path / "vimeo_keys.pkl"
        with open(keys, "wb") as f:
            pickle.dump({"keys": [f"{i:05d}_0001" for i in range(1, 101)]},
                        f)
        opt["datasets"]["train"]["cache_keys"] = str(keys)
    trainer = Trainer(opt, device="cpu", dcn_max_offset=8)
    which, per_epoch, val = BUILDS[cfg]
    assert type(trainer.model).__name__ == which
    assert len(trainer.train_loader) == per_epoch
    assert (None if trainer.val_loader is None
            else len(trainer.val_loader)) == val
