"""The port's losses, pyramids and LR schedules vs the JAX package on the CPU.

Inputs come from numpy seeds as float32 and go to both packages; values
and input gradients agree to 1e-5 (both compute in f32, in different
orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu import losses as jl
from realvsr_tpu.ops import pyramid as jp
from realvsr_tpu.schedules import build_lr_schedule as jax_schedule
from realvsr_tpu_torch import losses as tl
from realvsr_tpu_torch.ops import pyramid as tp
from realvsr_tpu_torch.schedules import build_lr_schedule, lr_scheduler

TOL = 1e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(seed, shape=(2, 64, 64, 3)):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    y = np.clip(x + rng.normal(size=shape).astype(np.float32) * 0.1, 0, 1)
    return x, y.astype(np.float32)


def _jax_value_grad(fn, x, y):
    val, g = jax.value_and_grad(lambda a: fn(a, jnp.asarray(y)))(
        jnp.asarray(x))
    return float(val), np.asarray(g)


def _torch_value_grad(fn, x, y):
    xt = torch.from_numpy(x).requires_grad_()
    val = fn(xt, torch.from_numpy(y))
    (g,) = torch.autograd.grad(val, xt)
    return val.item(), g.numpy()


@pytest.mark.parametrize("name", ["l1", "l2", "cb", "hb", "gw", "pyr",
                                  "lappyr", "msssim"])
def test_criterion_value_and_grad_match_jax(name):
    # msssim's 5 scales need >= 11 px at 1/16 of the input
    x, y = _pair(0, (2, 176, 176, 1) if name == "msssim" else (2, 64, 64, 3))
    jv, jg = _jax_value_grad(jl.get_pixel_criterion(name), x, y)
    tv, tg = _torch_value_grad(tl.get_pixel_criterion(name), x, y)
    np.testing.assert_allclose(tv, jv, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tg, jg, atol=TOL * max(1.0, np.abs(jg).max()))


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 600, 520, 1)])
def test_ssim_value_and_grad_match_jax(shape):
    """(600, 520): min side / 256 rounds to 2, so the average-pool
    downsampling runs."""
    x, y = _pair(1, shape)
    np.testing.assert_allclose(
        tl.ssim_value(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jl.ssim_value(jnp.asarray(x), jnp.asarray(y))), atol=TOL)
    jv, jg = _jax_value_grad(jl.ssim_loss, x, y)
    tv, tg = _torch_value_grad(tl.ssim_loss, x, y)
    np.testing.assert_allclose(tv, jv, atol=TOL)
    np.testing.assert_allclose(tg, jg, atol=TOL * max(1.0, np.abs(jg).max()))


def test_ssim_refuses_inputs_smaller_than_its_window():
    x = torch.rand(1, 10, 10, 1)
    with pytest.raises(ValueError, match="window"):
        tl.ssim_loss(x, x)


@pytest.mark.parametrize("fn", ["lap_pyramid", "gau_pyramid",
                                "laplacian_pyramid", "conv_gauss",
                                "upsample"])
def test_pyramids_match_jax(fn):
    x, _ = _pair(2, (2, 32, 48, 3))
    ref = getattr(jp, fn)(jnp.asarray(x))
    ours = getattr(tp, fn)(torch.from_numpy(x))
    ref = ref if isinstance(ref, list) else [ref]
    ours = ours if isinstance(ours, list) else [ours]
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)


def test_pyramid_loss_modes_match_jax():
    x, y = _pair(3)
    for pyr_mode in ("gau", "lap"):
        for loss_mode in ("l1", "cb", "hb"):
            kw = dict(num_levels=3, pyr_mode=pyr_mode, loss_mode=loss_mode)
            jv, jg = _jax_value_grad(
                lambda a, b: jl.pyramid_loss(a, b, **kw), x, y)
            tv, tg = _torch_value_grad(
                lambda a, b: tl.pyramid_loss(a, b, **kw), x, y)
            np.testing.assert_allclose(tv, jv, atol=TOL)
            np.testing.assert_allclose(tg, jg, atol=TOL)


def test_unknown_criterion_raises():
    with pytest.raises(NotImplementedError):
        tl.get_pixel_criterion("vgg")


def _split_train_opt():
    with open(os.path.join(REPO, "configs", "train",
                           "train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")) as f:
        return yaml.safe_load(f)["train"]


@pytest.mark.parametrize("cfg", [
    {},  # the Split recipe: cosine with restarts at 150k, 300k, 450k
    dict(lr_scheme="MultiStepLR", lr_steps=[100, 200, 200], lr_gamma=0.5,
         restarts=[250], restart_weights=[0.5], niter=400),
    dict(warmup_iter=50, niter=300, T_period=[100, 100, 100],
         restarts=[100, 200], restart_weights=[0.5, 0.25]),
])
def test_lr_schedule_matches_jax(cfg):
    train_opt = {**_split_train_opt(), **cfg}
    niter = int(train_opt["niter"])
    steps = sorted(set(range(0, niter + 2, max(1, niter // 997)))
                   | {r + d for r in train_opt.get("restarts") or []
                      for d in (-1, 0, 1, 2)})
    ours = build_lr_schedule(train_opt)
    ref = jax_schedule(train_opt)
    got = np.array([ours(s) for s in steps])
    want = np.array([float(ref(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12)


def test_lr_scheduler_gives_update_count_the_lr_of_count_plus_one():
    train_opt = {**_split_train_opt(), "niter": 20, "T_period": [8, 8, 8],
                 "restarts": [8, 16], "restart_weights": [1, 0.5]}
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=float(train_opt["lr_G"]))
    sched = lr_scheduler(opt, train_opt)
    fn = build_lr_schedule(train_opt)
    for count in range(20):
        assert opt.param_groups[0]["lr"] == pytest.approx(fn(count + 1),
                                                          rel=1e-12)
        opt.step()
        sched.step()
