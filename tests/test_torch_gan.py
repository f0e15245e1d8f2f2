"""The port's GAN-Split step (``realvsr_tpu_torch/train/gan.py``) and the
Combine wrapper's VGG feature loss against the JAX package's steps on
the CPU in f32.

The GAN: EDVR_NoUp at nf 16 / 4 groups / 1 + 1 ResBlocks against
``MultiscaleDiscriminator_v4`` (nf 8, 2 PatchGANs on the Y pyramid's HF
levels) on 48x48 crops, batch 2, the sizes of ``tests/test_gan_step.py``;
the recipe's train options (``train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.
yml``: ssim / cb / gw, ragan) without augmentation (the packages draw it
from different generators).  JAX variables are seeded random
(``torch_jax_params``: the DCN offset convs and D's running statistics
included) and carried over with ``state_dict_from_jax``.  JAX's step is
``realvsr_tpu.train.gan.make_gan_split_train_step`` under ``jax.jit`` on
a ``GANTrainState`` made from those variables.

Tolerances, after each step: every logged loss to 1e-5 relative (1e-4
for the SSIM structure loss of the 12x12 LF base, a difference of nearly
equal f32 sums); D's running statistics to 1e-5 relative, the running
means plus ``steps * 2 * LR`` (they take the bias of the conv before
their BN, whose updates are bounded as the parameters' are); every
parameter of G and D within ``steps * 2 * LR`` plus 1e-6 relative: Adam's
update is LR * m / (sqrt(v) + eps), at most ~LR a step whatever the
gradient, and a gradient near zero (BN-fed biases get zero but for
rounding) can take either sign in two f32 runs; beside it, the 99.9th
percentile of the differences over the rest of a model's parameters (all
but the biases of the convs that feed a BN) must stay under LR / 10.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.models import define_d as jax_define_d
from realvsr_tpu.models import define_g as jax_define_g
from realvsr_tpu.models.vgg import VGGFeatureExtractor as JaxVGG
from realvsr_tpu.train.gan import GANTrainState as JaxGANState
from realvsr_tpu.train.gan import _make_tx
from realvsr_tpu.train.gan import make_gan_split_train_step as jax_gan_step
from realvsr_tpu.train.state import TrainState as JaxTrainState
from realvsr_tpu.train.state import build_optimizer as jax_optimizer
from realvsr_tpu.train.wrappers import (
    make_combine_train_step as jax_combine_step)
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models import define_d, define_f, define_g
from realvsr_tpu_torch.train.gan import (create_gan_train_state,
                                         make_gan_split_train_step)
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.wrappers import make_train_step
from torch_jax_params import random_variables, smooth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAN_CFG = os.path.join(REPO, "configs", "train",
                       "train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opt(**train):
    with open(GAN_CFG) as f:
        opt = yaml.safe_load(f)
    opt["augment"] = None
    opt["network_G"].update(nf=16, groups=4, front_RBs=1, back_RBs=1,
                            center=None)
    opt["network_D"]["nf"] = 8
    opt["train"].update(train)
    return opt


def _vgg(rng, side):
    """JAX's VGG19 extractor with random weights, its apply, and the port's
    with the same weights."""
    jvgg = JaxVGG()
    jparams = random_variables(jvgg, rng, jnp.zeros((1, side, side, 3)))
    net_f = define_f(None, device="cpu")
    net_f.load_state_dict(state_dict_from_jax(jparams), strict=True)
    return (lambda x: jvgg.apply(jparams, x)), net_f


@functools.lru_cache(maxsize=None)
def _variables(seed):
    """Seeded random G and D variables of the GAN tests' networks (their
    shapes do not depend on the crop; one shape pass for every test)."""
    rng = np.random.default_rng(seed)
    opt = _opt()
    vg = random_variables(jax_define_g(opt), rng, jnp.zeros((2, 3, 48, 48, 3)))
    levels = [jnp.zeros((2, 48 >> i, 48 >> i, 1)) for i in range(2)]
    return vg, random_variables(jax_define_d(opt), rng, levels)


def _gan_states(opt, side, seed, feature=False):
    """Seeded random G and D variables; JAX's jitted step and state, and
    the port's step and state from the same variables."""
    rng = np.random.default_rng(seed)
    batch = smooth_batch(side, seed)
    jg, jd = jax_define_g(opt), jax_define_d(opt)
    vg, vd = _variables(0)
    j_fea, t_fea = _vgg(rng, side // 4) if feature else (None, None)
    tx_g, tx_d = _make_tx(opt["train"], "G"), _make_tx(opt["train"], "D")
    jstate = JaxGANState(
        step=0, params_g=vg["params"], params_d=vd["params"],
        opt_state_g=tx_g.init(vg["params"]),
        opt_state_d=tx_d.init(vd["params"]), apply_g=jg.apply,
        apply_d=jd.apply, tx_g=tx_g, tx_d=tx_d,
        batch_stats_d=vd["batch_stats"])
    jstep = jax.jit(jax_gan_step(jg, opt, feature_apply=j_fea))

    model_g = define_g(opt, device="cpu")
    model_g.load_state_dict(state_dict_from_jax(vg), strict=True)
    model_d = define_d(opt, device="cpu")
    model_d.load_state_dict(state_dict_from_jax(vd), strict=True)
    tstate = create_gan_train_state(model_g, model_d, opt)
    tstep = make_gan_split_train_step(model_g, opt, feature_apply=t_fea)
    return batch, (jstep, jstate), (tstep, tstate)


def _hold_params(named, ref, lr, steps, what):
    """Every parameter within steps * 2 * LR (+1e-6 relative); 99.9% of
    the elements of the others within LR / 10, where the others are all
    but the biases of the convs whose output a BN normalises (their
    gradients are zero but for rounding: module docstring)."""
    diffs = []
    for k, v in ref.items():
        torch.testing.assert_close(named[k].detach(), v, rtol=1e-6,
                                   atol=steps * 2 * lr,
                                   msg=lambda m: f"{what} {k}: {m}")
        pre, _, leaf = k.rpartition(".")
        bn_fed = leaf == "bias" and pre.replace(".conv", ".bn") + ".weight" \
            in named
        if not bn_fed:
            diffs.append((named[k].detach() - v).abs().flatten())
    diffs = torch.cat(diffs)
    assert torch.quantile(diffs, 0.999).item() < lr / 10, what


def _hold_step(jlogs, tlogs, jstate, tstate, lr_g, lr_d, step):
    assert set(tlogs) == set(jlogs)
    for k, v in jlogs.items():
        rel = 1e-4 if k == "l_g_pix_s" else 1e-5
        assert tlogs[k].item() == pytest.approx(float(v), rel=rel,
                                                abs=1e-9), k
    g_ref = state_dict_from_jax(jax.device_get(jstate.params_g))
    d_ref = state_dict_from_jax(jax.device_get(
        {"params": jstate.params_d, "batch_stats": jstate.batch_stats_d}))
    _hold_params(dict(tstate.model.named_parameters()), g_ref, lr_g, step,
                 "G")
    d_named = dict(tstate.model_d.named_parameters())
    _hold_params(d_named, {k: v for k, v in d_ref.items() if k in d_named},
                 lr_d, step, "D")
    buffers = dict(tstate.model_d.named_buffers())
    stats = {k: v for k, v in d_ref.items() if "running" in k}
    assert len(stats) == 2 * 6 * 2   # 2 Ds x 6 BNs, mean and var
    for k, v in stats.items():
        # a running mean follows the conv bias before its BN, which Adam
        # may move differently by up to 2 LR a step (module docstring)
        atol = 2 * lr_d * step if k.endswith("mean") else 1e-7
        torch.testing.assert_close(buffers[k], v, rtol=1e-5, atol=atol,
                                   msg=lambda m: f"{k}: {m}")
        assert buffers[k.rsplit(".", 1)[0] + ".num_batches_tracked"] \
            == 2 * step   # a real and a fake forward a step


GAN_CASES = {   # name: train options; G is gated off on steps 1 and 3
    "ragan": {},
    "gan_gated": dict(gan_type="gan", D_update_ratio=2, D_init_iters=1),
}


@pytest.mark.parametrize("case", list(GAN_CASES))
def test_three_gan_split_steps_match_jax(case):
    """Three GAN-Split steps (ragan; vanilla with ``D_update_ratio=2,
    D_init_iters=1``): losses, G and D parameters and D's running
    statistics after each step (module docstring's tolerances); on a gated
    step G is bit-unchanged and its optimizer and LR schedule do not
    move."""
    opt = _opt(**GAN_CASES[case])
    batch, (jstep, jstate), (tstep, tstate) = _gan_states(opt, 48, seed=0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    lr_g = float(opt["train"]["lr_G"])
    lr_d = float(opt["train"]["lr_D"])
    for i in range(1, 4):
        g_before = {k: v.detach().clone()
                    for k, v in tstate.model.named_parameters()}
        lr_before = tstate.scheduler_g.last_epoch
        jstate, jlogs = jstep(jstate, batch, jax.random.PRNGKey(i))
        tstate, tlogs = tstep(tstate, tbatch, torch.Generator())
        gated = case == "gan_gated" and i != 2
        assert tlogs["g_active"].item() == float(not gated)
        moved = [not torch.equal(g_before[k], v.detach())
                 for k, v in tstate.model.named_parameters()]
        assert not any(moved) if gated else all(moved)
        assert tstate.scheduler_g.last_epoch == lr_before + (not gated)
        assert tstate.scheduler_d.last_epoch == i
        assert tstate.step == i
        _hold_step(jlogs, tlogs, jstate, tstate, lr_g, lr_d, i)


def test_gan_split_step_with_the_feature_loss_matches_jax():
    """One ragan step with ``feature_weight`` 0.1: the VGG19 features
    (random weights) of the 1-channel LF base, at 64x64 (the base is 16x16,
    1x1 at conv5_4)."""
    opt = _opt(feature_criterion="cb", feature_weight=0.1)
    batch, (jstep, jstate), (tstep, tstate) = _gan_states(opt, 64, seed=1,
                                                          feature=True)
    jstate, jlogs = jstep(jstate, batch, jax.random.PRNGKey(0))
    tstate, tlogs = tstep(tstate, {k: torch.from_numpy(v)
                                   for k, v in batch.items()},
                          torch.Generator())
    assert tlogs["l_g_fea"].item() > 0
    _hold_step(jlogs, tlogs, jstate, tstate, float(opt["train"]["lr_G"]),
               float(opt["train"]["lr_D"]), 1)


def test_combine_step_with_the_feature_loss_matches_jax():
    """The Combine wrapper with a VGG19 feature loss (random weights; the
    prediction's features against the GT's, the latter without a
    gradient) and a Charbonnier pixel loss, on RCAN (x1, nf 16), one step
    against JAX's: the losses to 1e-5, every gradient-moved parameter as
    the GAN's."""
    opt = _opt()
    opt["model"] = "VideoSR_AllPair_YCbCr_Combine"
    opt["network_G"] = dict(which_model_G="RCAN", num_in_ch=3, num_out_ch=3,
                            num_frames=3, num_feat=16, num_group=1,
                            num_block=1, squeeze_factor=4, res_scale=1)
    opt["train"].update(pixel_criterion="cb", pixel_weight=1.0,
                        feature_criterion="l1", feature_weight=0.5,
                        lr_G=1e-4)
    rng = np.random.default_rng(2)
    batch = smooth_batch(32, 2)
    jmodel = jax_define_g(opt)
    variables = random_variables(jmodel, rng, jnp.asarray(batch["LQs"]))
    j_fea, t_fea = _vgg(rng, 32)
    jstate = JaxTrainState.create(apply_fn=jmodel.apply,
                                  params=variables["params"],
                                  tx=jax_optimizer(opt["train"]))
    jstate, jlogs = jax.jit(jax_combine_step(jmodel, opt, j_fea))(
        jstate, batch, jax.random.PRNGKey(0))
    model = define_g(opt, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    tstate = create_train_state(model, opt)
    tstate, tlogs = make_train_step(model, opt, t_fea)(
        tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator())
    assert set(tlogs) == set(jlogs) == {"l_pix", "l_fea", "l_tot"}
    for k, v in jlogs.items():
        assert tlogs[k].item() == pytest.approx(float(v), rel=1e-5), k
    _hold_params(dict(model.named_parameters()),
                 state_dict_from_jax(jax.device_get(jstate.params)),
                 float(opt["train"]["lr_G"]), 1, "G")
    assert all(p.grad is None for p in t_fea.parameters())
