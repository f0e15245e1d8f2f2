"""Kernels 3 and 5 of the TPU table: the port vs the JAX package on the CPU.

* The any-width conv (``conv3x3_fused``, ``conv3x3`` with two inputs) and
  its autograd against the JAX Pallas ``conv3x3_fused`` in interpret mode and
  the gradients of the JAX custom VJP ``conv3x3``, as
  ``tests/test_conv3x3_kernel.py`` holds them against ``lax.conv``.
* The block DCN API against the JAX ``modulated_deform_conv_block`` through
  its Pallas kernel (``use_pallas=True``, interpret mode) and through the XLA
  block path.

On the CPU the port's wrappers run their plain versions (the tensors lie on
the CPU); the kernels themselves are held to those on the card
(``tests/test_torch_cuda.py``).  Inputs come from numpy
seeds as float32; the port takes OIHW weights, JAX HWIO.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops.deform_conv_block import (
    modulated_deform_conv_block as jax_block)
from realvsr_tpu.ops.pallas.conv3x3_kernel import (
    conv3x3 as jax_conv3x3, conv3x3_fused as jax_conv3x3_fused)
from realvsr_tpu_torch.ops.deform_conv_block import (
    modulated_deform_conv_block)
from realvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3, conv3x3_autograd,
                                                   conv3x3_fused)

COUTS = [3, 8, 216, 256]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _oihw(w):
    return _t(w.transpose(3, 2, 0, 1))


def _conv_inputs(seed, cout, b=2, h=8, w=16, cin=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    res = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    return x, wgt, bias, res


@pytest.mark.parametrize("cout", COUTS)
@pytest.mark.parametrize("use_bias,act,use_res", [
    (True, None, False), (False, "relu", False), (True, "lrelu", True),
    (False, None, True)])
def test_conv3x3_fused_matches_jax_interpret(cout, use_bias, act, use_res):
    x, wgt, bias, res = _conv_inputs(cout, cout)
    ref = jax_conv3x3_fused(
        jnp.asarray(x), jnp.asarray(wgt),
        jnp.asarray(bias) if use_bias else None, act=act,
        residual=jnp.asarray(res) if use_res else None, mrows=4,
        interpret=True)
    out = conv3x3_fused(_t(x), _oihw(wgt), _t(bias) if use_bias else None,
                        act, _t(res) if use_res else None)
    assert out.shape == (2, 8, 16, cout)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_conv3x3_two_inputs_any_width():
    """The second input pointer at cout 3: the conv of the concat."""
    x, wgt, bias, _ = _conv_inputs(5, 3, cin=32)
    ref = jax_conv3x3_fused(jnp.asarray(x), jnp.asarray(wgt),
                            jnp.asarray(bias), act="lrelu", mrows=4,
                            interpret=True)
    out = conv3x3(_t(x[..., :16]), _oihw(wgt), _t(bias), "lrelu",
                  x2=_t(x[..., 16:]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


def test_conv3x3_fused_takes_only_the_repo_slope():
    x, wgt, _, _ = _conv_inputs(6, 3)
    with pytest.raises(ValueError, match="slope"):
        conv3x3_fused(_t(x), _oihw(wgt), act="lrelu", alpha=0.2)


@pytest.mark.parametrize("cout", COUTS)
def test_conv3x3_autograd_matches_jax_custom_vjp(cout):
    x, wgt, _, _ = _conv_inputs(cout + 1, cout)

    def loss(x_, w_):
        return jnp.sum(jnp.sin(jax_conv3x3(x_, w_, True)))

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(wgt))
    xt, wt = _t(x).requires_grad_(), _oihw(wgt).requires_grad_()
    out = conv3x3_autograd(xt, wt)
    dx, dw = torch.autograd.grad(torch.sin(out).sum(), (xt, wt))
    np.testing.assert_allclose(dx.numpy(), np.asarray(gx), atol=2e-5)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), np.asarray(gw),
                               atol=1e-4)


def _block_inputs(seed, b=1, h=8, w=16, cin=16, cout=8, dg=4):
    """Offsets of std 2.5 px: many beyond the clamp R = 3, taps outside."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, dg * 18)) * 2.5).astype(np.float32)
    m = rng.uniform(size=(b, h, w, dg * 9)).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    return x, off, m, wgt, bias


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas_interpret", "xla_block"])
@pytest.mark.parametrize("with_mask", [True, False])
def test_block_api_matches_jax(use_pallas, with_mask):
    r, dg = 3, 4
    x, off, m, wgt, bias = _block_inputs(7)
    ref = jax_block(jnp.asarray(x), jnp.asarray(off),
                    jnp.asarray(m) if with_mask else None, jnp.asarray(wgt),
                    jnp.asarray(bias), deformable_groups=dg, max_offset=r,
                    use_pallas=use_pallas, pallas_interpret=use_pallas)
    out = modulated_deform_conv_block(
        _t(x), _t(off), _t(m) if with_mask else None, _oihw(wgt), _t(bias),
        deformable_groups=dg, max_offset=r)
    assert out.shape == (1, 8, 16, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    # the clamp is in play: the unclamped op differs
    free = modulated_deform_conv_block(
        _t(x), _t(off), _t(m) if with_mask else None, _oihw(wgt), _t(bias),
        deformable_groups=dg, max_offset=100)
    assert (free - out).abs().max() > 1e-2


def test_block_api_takes_3x3_pad_1_only():
    x, off, m, wgt, bias = _block_inputs(8)
    with pytest.raises(ValueError, match="3x3"):
        modulated_deform_conv_block(_t(x), _t(off), _t(m), _oihw(wgt),
                                    padding=0, deformable_groups=4)
