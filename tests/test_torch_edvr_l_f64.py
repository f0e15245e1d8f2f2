"""EDVR-L's CPU parity step settled against float64: both packages' f32
gradients of one Split loss held against a float64 run of each.

``test_torch_edvr_l.py`` holds the port's f32 step to JAX's f32 step within
1e-4 of each gradient's largest (5e-4 on the DCN offset chains) plus how
far JAX's own two exact DCN implementations lie apart.  Whether that gap is
f32 rounding or a difference of function is settled here, as
``test_torch_gan.py`` settled SpyNet's: EDVR-L at the same debug size (nf
128, 8 deformable groups, 1 + 1 ResBlocks, 5 frames, LQ 16x16, TSA), the
same motion batch and variables, the recipe's Split loss (``pyr`` on Y,
``lappyr`` on CbCr), its gradient taken four times:

* JAX in float32 and in float64 (``define_g(opt, dtype=jnp.float64)``;
  ``tests/conftest.py`` enables x64), the exact (columns) DCN;
* the port in float32 and in float64 on the CPU (its plain ops run in f64
  for float64 inputs).

The offset convs are drawn at the parity test's std (0.5 / sqrt(8)) and at
0.5, where the offsets reach ~17 px on the 16 px frame and the gap first
showed.  Checks:

* the two float64 gradients agree within 1e-6 of each tensor's largest
  (one function; they differ by ~5e-8 on every tensor alike, a difference
  in the losses, whose windows both packages hold as float32 arrays, and
  far below the f32 runs' own errors);
* the port's f32 gradient lies no farther from its float64 one than twice
  the farthest JAX's f32 gradient lies from JAX's float64 one, over every
  tensor (at std 0.5 both reach ~3e-3 of a tensor's largest: f32 rounding
  through the exact DCN's position derivative, which jumps where a sample
  crosses a pixel, in both packages alike; at the parity std ~1e-5);
* at the parity test's std, each tensor's two f32 distances together fit
  the bound ``test_torch_edvr_l.py`` holds the f32 pair to.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.losses import get_pixel_criterion as jax_criterion
from realvsr_tpu.models import define_g as jax_define_g
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu_torch.convert import (_to_torch_layout, flax_path_to_torch_key,
                                       state_dict_from_jax)
from realvsr_tpu_torch.losses import get_pixel_criterion
from realvsr_tpu_torch.models import define_g
from test_torch_train_families import (OFFSET_GRAD_REL, _batch, _opt,
                                       _randomise_offset_convs)
from torch_jax_params import random_variables

NAME = "edvr_l"
F64_REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_grads(opt, params, batch, dtype, impl=None):
    """The Split loss's gradient in ``dtype``, torch keys and layouts,
    float64 numpy."""
    t = opt["train"]
    cri_y = jax_criterion(t["pixel_criterion_y"])
    cri_c = jax_criterion(t["pixel_criterion_c"])
    jmodel = jax_define_g(opt, dtype=dtype)
    p = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    lq = jnp.asarray(batch["LQs"], dtype)
    gt = jnp.asarray(batch["GT"][:, batch["LQs"].shape[1] // 2], dtype)

    def loss_fn(p_):
        pred = jmodel.apply({"params": p_}, lq)
        return (cri_y(pred[..., 0:1], gt[..., 0:1])
                + cri_c(pred[..., 1:3], gt[..., 1:3]))

    prev = jdc.set_default_impl(impl)
    try:
        g = jax.device_get(jax.jit(jax.grad(loss_fn))(p))
    finally:
        jdc.set_default_impl(*prev)
    return {flax_path_to_torch_key(path): _to_torch_layout(
        path, np.asarray(leaf, np.float64)) for path, leaf in _leaves(g)}


def _port_grads(opt, params, batch, dtype):
    t = opt["train"]
    cri_y = get_pixel_criterion(t["pixel_criterion_y"])
    cri_c = get_pixel_criterion(t["pixel_criterion_c"])
    model = define_g(opt, device="cpu", dtype=dtype)
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    model.train()
    lq = torch.from_numpy(batch["LQs"]).to(dtype)
    gt = torch.from_numpy(batch["GT"][:, batch["LQs"].shape[1] // 2]).to(
        dtype)
    pred = model(lq)
    loss = (cri_y(pred[..., 0:1], gt[..., 0:1])
            + cri_c(pred[..., 1:3], gt[..., 1:3]))
    loss.backward()
    return {k: p.grad.double().numpy() for k, p in model.named_parameters()}


STDS = {"parity_std": 0.5 / 8 ** 0.5, "large_offsets": 0.5}


@pytest.fixture(scope="module")
def grads(request):
    batch = _batch(NAME)
    opt = _opt(NAME)
    jmodel = jax_define_g(opt)
    params = random_variables(jmodel, np.random.default_rng(0),
                              jnp.asarray(batch["LQs"]))["params"]
    _randomise_offset_convs(params, np.random.default_rng(1),
                            std=STDS[request.param])
    return dict(
        jax32=_jax_grads(opt, params, batch, jnp.float32),
        jax32_tap=_jax_grads(opt, params, batch, jnp.float32, "tap_loop"),
        jax64=_jax_grads(opt, params, batch, jnp.float64),
        port32=_port_grads(opt, params, batch, torch.float32),
        port64=_port_grads(opt, params, batch, torch.float64))


def _scale(g):
    return max(np.abs(g).max(), 1e-30)


@pytest.mark.parametrize("grads", list(STDS), indirect=True)
def test_float64_gradients_agree(grads):
    """The port and JAX compute one function: their float64 gradients
    agree within F64_REL of each tensor's largest."""
    j, p = grads["jax64"], grads["port64"]
    assert j.keys() == p.keys()
    for k in j:
        err = np.abs(p[k] - j[k]).max() / _scale(j[k])
        assert err <= F64_REL, (k, err)


def _rel_errors(grads):
    """Per tensor: (JAX's, the port's) f32 distance from its own package's
    float64 gradient, relative to the tensor's largest."""
    out = {}
    for k, g64 in grads["jax64"].items():
        scale = _scale(g64)
        out[k] = (np.abs(grads["jax32"][k] - g64).max() / scale,
                  np.abs(grads["port32"][k] - grads["port64"][k]).max()
                  / scale)
    return out


@pytest.mark.parametrize("grads", list(STDS), indirect=True)
def test_float32_errors_are_rounding_as_jax(grads):
    """The port's f32 gradients are as close to float64 as JAX's: each
    within twice the farthest JAX's f32 gradient lies from its float64
    one."""
    errs = _rel_errors(grads)
    jax_worst = max(e for e, _ in errs.values())
    for k, (_, e_port) in errs.items():
        assert e_port <= 2 * jax_worst, (k, e_port, jax_worst)


@pytest.mark.parametrize("grads", ["parity_std"], indirect=True)
def test_float32_errors_fit_the_parity_bound(grads):
    """Each package's f32 gradient lies at its own f32 rounding from its
    float64 one, and the two distances together fit the bound
    ``test_torch_edvr_l.py`` holds the f32 pair to (rel of the largest,
    plus JAX's columns-vs-tap-loop spread): the gap between the f32 steps
    is rounding, not a fault."""
    for k, (e_jax, e_port) in _rel_errors(grads).items():
        g64 = grads["jax64"][k]
        spread = np.abs(grads["jax32"][k] - grads["jax32_tap"][k]).max()
        rel = OFFSET_GRAD_REL if "offset" in k else 1e-4
        assert e_jax + e_port <= rel + spread / _scale(g64), (k, e_jax,
                                                              e_port)
