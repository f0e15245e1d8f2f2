"""The rest of the JAX package's public API in the port, against the JAX
package on the CPU, same numpy inputs (float32 on both sides):

* ``losses``: ``tv_loss`` (a sum) and ``style_loss`` (Gram MSE, the
  target's Gram matrix without gradient), values and gradients, 1e-5
  relative (f32 sums in other orders);
* ``ops.metrics``: ``psnr`` and ``ssim`` on tensors, at data ranges 255
  and 1, 1e-5 relative (PSNR 1e-5 dB);
* ``ops.color``: ``rgb2ycbcr`` (with ``only_y``), ``bgr2ycbcr``,
  ``ycbcr2rgb``, ``ycbcr2bgr`` on float and uint8 tensors (uint8 exact;
  float 1e-6) and a gradient through one;
* ``models.common``: ``lrelu``; ``ResBlock`` (``res_scale``) and
  ``make_layer``,
  variables from ``tests/torch_jax_params.random_variables`` moved with
  ``state_dict_from_jax`` and a strict load, 1e-5 of the output's
  largest, one step's gradients 1e-5 of each's largest.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu import losses as jl
from realvsr_tpu.models import common as jcommon
from realvsr_tpu.ops import color as jcolor
from realvsr_tpu.ops import metrics as jmetrics
from realvsr_tpu_torch import losses as tl
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models.common import ResBlock, lrelu, make_layer
from realvsr_tpu_torch.ops import color as tcolor
from realvsr_tpu_torch.ops import metrics as tmetrics
from torch_jax_params import random_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(ours, ref, rel=1e-5, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("name", ["tv_loss", "style_loss"])
def test_losses_and_grads_match_jax(name):
    x, y = _rand(0, 2, 12, 10, 5), _rand(1, 2, 12, 10, 5)
    jfn, tfn = getattr(jl, name), getattr(tl, name)
    assert name in jl.__all__ and name in tl.__all__
    args = (x,) if name == "tv_loss" else (x, y)
    ref, jgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])
    leaves = [_t(a).requires_grad_() for a in args]
    ours = tfn(*leaves)
    ours.backward()
    _close(ours.item(), ref)
    _close(leaves[0].grad.numpy(), jgrads[0], msg="grad")
    if name == "style_loss":   # the target carries no gradient
        assert leaves[1].grad is None
        assert not np.abs(np.asarray(jgrads[1])).any()


@pytest.mark.parametrize("data_range", [255.0, 1.0])
def test_psnr_and_ssim_on_tensors_match_jax(data_range):
    a = _rand(2, 40, 48) * data_range
    b = np.clip(a + np.random.default_rng(3).normal(size=a.shape)
                .astype(np.float32) * 0.05 * data_range, 0, data_range)
    ref_p = jmetrics.psnr(jnp.asarray(a), jnp.asarray(b), data_range)
    ref_s = jmetrics.ssim(jnp.asarray(a), jnp.asarray(b), data_range)
    ours_p = tmetrics.psnr(_t(a), _t(b), data_range)
    ours_s = tmetrics.ssim(_t(a), _t(b), data_range)
    np.testing.assert_allclose(ours_p.item(), float(ref_p), atol=1e-5)
    _close(ours_s.item(), ref_s)
    # the host metrics agree at 255
    if data_range == 255.0:
        np.testing.assert_allclose(
            ours_p.item(), tmetrics.calculate_psnr_np(a, b), atol=1e-3)
        np.testing.assert_allclose(
            ours_s.item(), tmetrics.calculate_ssim_np(a, b), atol=1e-5)


@pytest.mark.parametrize("fn,kw", [("rgb2ycbcr", {}),
                                   ("rgb2ycbcr", {"only_y": True}),
                                   ("bgr2ycbcr", {}),
                                   ("bgr2ycbcr", {"only_y": True}),
                                   ("ycbcr2rgb", {}), ("ycbcr2bgr", {})])
def test_color_on_tensors_matches_jax(fn, kw):
    img = _rand(4, 2, 7, 9, 3)
    ref = getattr(jcolor, fn)(jnp.asarray(img), **kw)
    ours = getattr(tcolor, fn)(_t(img), **kw)
    assert ours.shape == ref.shape and ours.dtype == torch.float32
    _close(ours.numpy(), ref, rel=1e-6)
    u8 = (img * 255).round().astype(np.uint8)
    ref8 = np.asarray(getattr(jcolor, fn)(jnp.asarray(u8), **kw))
    ours8 = getattr(tcolor, fn)(_t(u8), **kw)
    assert ours8.dtype == torch.uint8
    np.testing.assert_array_equal(ours8.numpy(), ref8)


def test_color_differentiates_as_jax():
    """A Y-channel L1 through rgb2ycbcr, as a loss takes it."""
    x, y = _rand(5, 1, 6, 6, 3), _rand(6, 1, 6, 6, 3)

    def jloss(a):
        return jnp.abs(jcolor.rgb2ycbcr(a, only_y=True)
                       - jcolor.rgb2ycbcr(jnp.asarray(y), only_y=True)).mean()

    ref = jax.grad(jloss)(jnp.asarray(x))
    leaf = _t(x).requires_grad_()
    (tcolor.rgb2ycbcr(leaf, only_y=True)
     - tcolor.rgb2ycbcr(_t(y), only_y=True)).abs().mean().backward()
    _close(leaf.grad.numpy(), ref, rel=1e-6)


@pytest.mark.parametrize("res_scale,n", [(1.0, 1), (0.1, 3)])
def test_resblock_and_make_layer_match_jax(res_scale, n):
    """``n`` EDSR ResBlocks (16 features) through ``make_layer``: output and
    the gradients of a sum against JAX's."""
    import flax.linen as fnn

    class Stack(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            for blk in jcommon.make_layer(jcommon.ResBlock, n, n_feats=16,
                                          res_scale=res_scale):
                x = blk(x)
            return x

    x = np.random.default_rng(7).normal(size=(2, 10, 12, 16)).astype(
        np.float32)
    jmod = Stack() if n > 1 else jcommon.ResBlock(16, res_scale=res_scale)
    variables = random_variables(jmod, np.random.default_rng(8),
                                 jnp.asarray(x))
    ref, vjp = jax.vjp(lambda p: jmod.apply({"params": p}, jnp.asarray(x)),
                       variables["params"])
    port = (make_layer(ResBlock, n, n_feats=16, res_scale=res_scale) if n > 1
            else ResBlock(16, res_scale=res_scale))
    port.load_state_dict(state_dict_from_jax(variables["params"]),
                         strict=True)
    ours = port(_t(x))
    _close(ours.detach().numpy(), ref)
    cot = np.random.default_rng(9).normal(size=ref.shape).astype(np.float32)
    ours.backward(_t(cot))
    jgrads = state_dict_from_jax(jax.device_get(vjp(jnp.asarray(cot))[0]))
    named = dict(port.named_parameters())
    assert named.keys() == jgrads.keys()
    for k, g in jgrads.items():
        _close(named[k].grad.numpy(), g.numpy(), msg=k)


def test_lrelu_matches_jax():
    x = np.random.default_rng(10).normal(size=(3, 4, 5)).astype(np.float32)
    for slope in (0.1, 0.2):
        _close(lrelu(_t(x), slope).numpy(), jcommon.lrelu(jnp.asarray(x),
                                                          slope), rel=0)
