"""Training TOF, FSTRN and RCAN in the port, against the JAX package on the
CPU: one Split step of each (``train_{TOF,FSTRN,RCAN}_RealVSR_YCbCr_Split.
yml``'s losses and Adam, depth and width cut) against JAX's Split wrapper
as it runs them (``_forward_train``: TOF's SpyNet BNs in train mode with
their running statistics written, FSTRN and RCAN applied as at inference).

Batches are smooth seeded frames, 48x48 (the recipe's lappyr SSIM needs
44 px, TOF's SpyNet sizes that divide by 8), batch 2, 3 frames; JAX
variables are seeded random (``torch_jax_params``) and carried over with
``state_dict_from_jax``.

Tolerances: the loss to 1e-5 relative; each gradient to 1e-4 of its
tensor's largest, or of the model's largest for the biases of SpyNet's
convs, which feed a BN and get zero gradients but for rounding.  SpyNet's
other gradients to 2e-2 of their tensor's largest: they pass BNs over 72
values a channel at the 6x6 level and the warps' position derivatives,
and against a float64 run of the port JAX's f32 step is up to 3.5e-3 off
there, the port's f32 step up to 1.2e-2 (the trunk's gradients of both
within 1e-4 of it, as are FSTRN's and RCAN's).  Each
parameter after Adam within 2 LR (+1e-6 relative: Adam's first update is
LR * g / (|g| + eps), so a gradient near zero may move either way) and
99.9% of the elements outside SpyNet within LR / 10; TOF's running
statistics to 1e-5 relative.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.losses import get_pixel_criterion as jax_criterion
from realvsr_tpu.models import define_g as jax_define_g
from realvsr_tpu.train.state import TrainState as JaxTrainState
from realvsr_tpu.train.state import build_optimizer as jax_optimizer
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.wrappers import make_split_train_step
from torch_jax_params import random_variables, smooth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CUTS = {   # the recipe's network_G, cut to test size
    "TOF": dict(nf=16, nb=1),
    "FSTRN": dict(nf=16),
    "RCAN": dict(num_feat=16, num_group=1, num_block=2, squeeze_factor=4),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recipe(which):
    with open(os.path.join(REPO, "configs", "train",
                           f"train_{which}_RealVSR_YCbCr_Split.yml")) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")   # the packages draw it from different generators
    opt["network_G"].update(CUTS[which])
    return opt


def _jax_split_step(opt, jmodel, variables, batch):
    """JAX's Split step as ``realvsr_tpu/train/wrappers.py`` takes it
    (``_forward_train``, the loss, ``value_and_grad``, Adam), returning its
    gradients too: (loss, grads, params after, batch_stats after)."""
    t = opt["train"]
    cri_y = jax_criterion(t["pixel_criterion_y"])
    cri_c = jax_criterion(t["pixel_criterion_c"])
    bs = variables.get("batch_stats", {})
    state = JaxTrainState.create(apply_fn=jmodel.apply,
                                 params=variables["params"],
                                 tx=jax_optimizer(t), batch_stats=bs)
    lq = jnp.asarray(batch["LQs"])
    gt_c = jnp.asarray(batch["GT"][:, 1])

    def step(state):
        def loss_fn(p):
            if state.batch_stats:
                pred, mut = state.apply_fn(
                    {"params": p, "batch_stats": state.batch_stats}, lq,
                    train=True, mutable=["batch_stats"])
                new_bs = mut["batch_stats"]
            else:
                pred, new_bs = state.apply_fn({"params": p}, lq), {}
            return (cri_y(pred[..., 0:1], gt_c[..., 0:1])
                    + cri_c(pred[..., 1:3], gt_c[..., 1:3])), new_bs

        (loss, new_bs), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.params)
        return loss, g, state.apply_gradients(grads=g, batch_stats=new_bs)

    loss, grads, new = jax.jit(step)(state)
    return (float(loss), state_dict_from_jax(jax.device_get(grads)),
            state_dict_from_jax(jax.device_get(
                {"params": new.params, "batch_stats": new.batch_stats})))


@pytest.mark.parametrize("which", list(CUTS))
def test_split_step_matches_jax(which):
    opt = _recipe(which)
    rng = np.random.default_rng(7)
    batch = smooth_batch(48, 7)
    jmodel = jax_define_g(opt)
    variables = random_variables(jmodel, rng, jnp.asarray(batch["LQs"]))
    loss, grads, after = _jax_split_step(opt, jmodel, variables, batch)

    model = define_g(opt, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    state = create_train_state(model, opt)
    _, logs = make_split_train_step(model, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator())
    assert logs["l_pix"].item() == pytest.approx(loss, rel=1e-5)
    named = dict(model.named_parameters())
    assert named.keys() == grads.keys()
    top = max(g.abs().max().item() for g in grads.values())
    lr = float(opt["train"]["lr_G"])
    diffs = []
    for k, g in grads.items():
        spynet = k.startswith("align_arch")
        bn_fed = spynet and k.endswith("bias") and "conv4" not in k
        tol = (1e-4 * top if bn_fed
               else (2e-2 if spynet else 1e-4) * g.abs().max().item())
        torch.testing.assert_close(named[k].grad, g, rtol=0, atol=tol,
                                   msg=lambda m: f"grad {k}: {m}")
        p = named[k].detach()
        torch.testing.assert_close(p, after[k], rtol=1e-6, atol=2 * lr,
                                   msg=lambda m: f"param {k}: {m}")
        if not spynet:
            diffs.append((p - after[k]).abs().flatten())
    assert torch.quantile(torch.cat(diffs), 0.999).item() < lr / 10
    stats = {k: v for k, v in after.items() if "running" in k}
    assert len(stats) == (32 if which == "TOF" else 0)
    buffers = dict(model.named_buffers())
    for k, v in stats.items():
        torch.testing.assert_close(buffers[k], v, rtol=1e-5, atol=1e-7,
                                   msg=lambda m: f"{k}: {m}")


def _cli(cfg, tmp_path, monkeypatch, edit):
    """``tools/train --device cpu`` on a copy of ``cfg`` changed by
    ``edit(opt)``; returns (opt, the trainer's final state, the experiment
    directory, the training log)."""
    from realvsr_tpu_torch.core import config
    from realvsr_tpu_torch.tools import train

    with open(os.path.join(REPO, "configs", "train", cfg)) as f:
        opt = yaml.safe_load(f)
    edit(opt)
    yml = tmp_path / cfg
    yml.write_text(yaml.safe_dump(opt))
    monkeypatch.setattr(train, "parse", lambda path, is_train=True: (
        config.parse(path, is_train=is_train, root=str(tmp_path))))
    state = train.main(["-opt", str(yml), "--device", "cpu"])
    exp = tmp_path / "experiments" / opt["name"]
    return opt, state, exp, (exp / "train.log").read_text()


def _log_values(log, key):
    return [float(ln.split(f" {key}: ")[1].split()[0])
            for ln in log.splitlines() if f" {key}: " in ln]


@pytest.mark.parametrize("which", list(CUTS))
def test_train_cli_runs_the_smoke_configs(which, tmp_path, monkeypatch):
    """A shrunk copy of ``smoke_{TOF,FSTRN,RCAN}_motion.yml`` (the cuts of
    CUTS, 48x48 crops, batch 1, 2 iterations, bf16 as configured) through
    ``tools/train --device cpu``: both steps logged with finite losses,
    validation at the end finite, the checkpoint loads with strict=True."""
    def edit(opt):
        opt["network_G"].update(CUTS[which])
        opt["datasets"]["train"].update(
            GT_size=48, frame_h=64, frame_w=64, batch_size=1, n_workers=2,
            num_seqs=2, frames_per_seq=4, dataset_ratio=2)
        opt["datasets"]["val"].update(frame_h=32, frame_w=32)
        opt["train"].update(niter=2, T_period=[2], val_freq=2)
        opt["logger"].update(print_freq=1, save_checkpoint_freq=2)

    opt, state, exp, log = _cli(f"smoke_{which}_motion.yml", tmp_path,
                                monkeypatch, edit)
    assert state.step == 2
    for key in ("l_pix_y", "l_pix_c", "l_pix"):
        vals = _log_values(log, key)
        assert len(vals) == 2 and np.isfinite(vals).all()
    psnr = [float(ln.split("PSNR: ")[1].rstrip("."))
            for ln in log.splitlines() if "# Validation # PSNR" in ln]
    assert len(psnr) == 1 and np.isfinite(psnr[0])
    assert sorted(os.listdir(exp / "models")) == ["2_G.pth", "latest_G.pth"]
    model = define_g(opt, device="cpu")
    model.load_state_dict(torch.load(exp / "models" / "latest_G.pth",
                                     weights_only=True), strict=True)


def test_train_cli_runs_and_resumes_the_gan_debug_config(tmp_path,
                                                         monkeypatch):
    """A shrunk copy of ``debug_EDVR-GAN_Split_synthetic.yml`` (4
    iterations at 48x48, batch 2; validation and G / D checkpoints at 2
    and 4, under another name: a debug name fixes them at 8) through ``tools/train --device cpu``, every JAX log key logged
    and finite; then a resume from the step-2 state: G, D, both optimizers
    and both schedulers come back, and it trains on to step 4."""
    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train.trainer import Trainer

    def edit(opt):   # renamed: a "debug" name sets validation at 8
        opt["name"] = "shrunk_EDVR-GAN_Split_synthetic"
        opt["datasets"]["train"].update(GT_size=48, batch_size=2)
        opt["train"].update(niter=4, T_period=[4, 4], restarts=[4],
                            val_freq=2)
        opt["logger"].update(print_freq=1, save_checkpoint_freq=2)

    opt, state, exp, log = _cli("debug_EDVR-GAN_Split_synthetic.yml",
                                tmp_path, monkeypatch, edit)
    assert state.step == 4
    for key in ("l_g_pix_s", "l_g_pix_d", "l_g_pix_c", "l_g_gan",
                "l_g_total", "l_d_real", "l_d_fake", "g_active"):
        vals = _log_values(log, key)
        assert len(vals) == 4 and np.isfinite(vals).all(), key
    assert log.count("# Validation # PSNR") == 2
    assert sorted(os.listdir(exp / "models")) == [
        "2_D.pth", "2_G.pth", "4_D.pth", "4_G.pth", "latest_D.pth",
        "latest_G.pth"]

    opt["path"] = dict(opt["path"], resume_state=str(
        exp / "training_state" / "2.state"))
    yml = tmp_path / "resume.yml"
    yml.write_text(yaml.safe_dump(opt))
    trainer = Trainer(parse(str(yml), root=str(tmp_path)), device="cpu",
                      dcn_max_offset=8.0)
    assert trainer.current_step == trainer.state.step == 2
    assert [s.last_epoch for s in trainer.state.schedulers] == [2, 2]
    assert all(len(o.state) for o in trainer.state.optimizers)
    for net, label in ((trainer.model, "G"), (trainer.model_d, "D")):
        sd = torch.load(exp / "models" / f"2_{label}.pth", weights_only=True)
        for k, v in net.state_dict().items():
            assert torch.equal(v, sd[k]), k
    assert trainer.train().step == 4


# config: (G class, D class or None, iterations an epoch, validation
# windows); the RealVSR and Vimeo90K frames are not in the repo (their key
# lists are, or are written here), so their validation folders are empty
BUILDS = {
    "debug_EDVR-GAN_Split_synthetic.yml": (
        "EDVRNoUp", "MultiscaleDiscriminatorV4", 32, 4),
    "gan_motion_3k.yml": ("EDVRNoUp", "MultiscaleDiscriminatorV4", 1920, 12),
    "train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml": (
        "EDVRNoUp", "MultiscaleDiscriminatorV4", 140625, 0),
    "train_TOF-GAN_RealVSR_YCbCr_Split.yml": (
        "TOF", "MultiscaleDiscriminatorV4", 140625, 0),
    "smoke_TOF_motion.yml": ("TOF", None, 640, 4),
    "smoke_FSTRN_motion.yml": ("FSTRN", None, 640, 4),
    "smoke_RCAN_motion.yml": ("RCAN", None, 640, 4),
    **{f"train_{m}_{kind}.yml": (m, None, n, 0)
       for m in ("TOF", "FSTRN", "RCAN")
       for kind, n in (("RealVSR_YCbCr_Split", 140625),
                       ("RealVSR_YCbCr_Combine", 140625),
                       ("Vimeo90K", 625))},
}


@pytest.mark.parametrize("cfg", list(BUILDS))
def test_trainer_builds_each_new_config(cfg, tmp_path):
    """The 16 configs whose networks the port could not build before (the
    GANs, TOF, FSTRN, RCAN) build their Trainer as parsed on the CPU:
    datasets, G (and D), optimizers, the train step; pretrained-model paths
    nulled (the weights are not in the repo)."""
    import pickle

    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train.trainer import Trainer

    opt = parse(os.path.join(REPO, "configs", "train", cfg),
                root=str(tmp_path))
    opt["path"]["pretrain_model_G"] = None
    if "Vimeo90K" in cfg:
        keys = tmp_path / "vimeo_keys.pkl"
        with open(keys, "wb") as f:
            pickle.dump({"keys": [f"{i:05d}_0001" for i in range(1, 101)]},
                        f)
        opt["datasets"]["train"]["cache_keys"] = str(keys)
    trainer = Trainer(opt, device="cpu", dcn_max_offset=8)
    g, d, per_epoch, val = BUILDS[cfg]
    assert type(trainer.model).__name__ == g
    assert (None if trainer.model_d is None
            else type(trainer.model_d).__name__) == d
    assert len(trainer.state.optimizers) == (2 if d else 1)
    assert len(trainer.train_loader) == per_epoch
    assert (0 if trainer.val_loader is None
            else len(trainer.val_loader)) == val
    assert callable(trainer.train_step)
