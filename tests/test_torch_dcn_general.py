"""The port's general DCN surface against the JAX package on the CPU.

Inputs are drawn from numpy seeds and go to both packages as float32.
Tolerances are 1e-5 x the largest magnitude of each result (at least 1)
where both sides compute the exact op in f32 with sums in other orders
(a bias gradient sums a few hundred terms of order one), and 5e-6 against
JAX's frame path, whose int16 positions are exact for offsets on a
1/256-px grid (as ``tests/test_torch_dcn_grad.py`` holds it).

* ``deform_conv`` (DCNv1), ``deform_conv_columns`` and
  ``modulated_deform_conv`` with ``groups`` 2, stride 2 and dilation 2
  (the plain op, on either device) and at 3x3 / p1 (the kernels' shape,
  whose CPU form is the plain op too), with gradients by ``jax.vjp``;
* ``DCNPack`` with ``extra_offset_mask=False``, cout != cin, kernel_size
  5, and in the PCD-align mode at cout != cin; ``DeformConvModule`` at p0
  and p1 (their variables from ``tests/torch_jax_params.random_variables``,
  the offset convs random too, moved with ``state_dict_from_jax`` and a
  strict load);
* the plain op (what the kernels are held to on the card) against JAX's
  frame path (``use_pallas="frame"``, the Pallas ``dcn_frame_fused`` in
  interpret mode) at cin != cout and with no mask.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models.common import DCNPack as JaxDCNPack
from realvsr_tpu.models.common import DeformConvModule as JaxDeformConv
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu.ops.deform_conv_block import modulated_deform_conv_block
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models.common import DCNPack, DeformConvModule
from realvsr_tpu_torch.ops.deform_conv import (deform_conv,
                                               deform_conv_columns,
                                               modulated_deform_conv,
                                               modulated_deform_conv_plain)
from torch_jax_params import random_variables

REL = 1e-5


def _close(ours, ref, rel=REL, msg=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(ours), ref, rtol=0,
                               atol=rel * max(1.0, np.abs(ref).max()),
                               err_msg=msg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


def _out(n, k, s, p, d):
    return (n + 2 * p - (d * (k - 1) + 1)) // s + 1


def _inputs(seed, cin=8, cout=6, dg=2, k=3, stride=1, padding=1,
            dilation=1, groups=1, b=2, h=9, w=11, mask=True):
    rng = np.random.default_rng(seed)
    ho, wo = (_out(n, k, stride, padding, dilation) for n in (h, w))
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    off = (rng.normal(size=(b, ho, wo, dg * k * k * 2)) * 2.5
           ).astype(np.float32)
    m = (rng.uniform(size=(b, ho, wo, dg * k * k)).astype(np.float32)
         if mask else None)
    wgt = (rng.normal(size=(k, k, cin // groups, cout)) * 0.3
           ).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, ho, wo, cout)).astype(np.float32)
    return x, off, m, wgt, bias, g


CASES = {
    "groups2": dict(cin=8, cout=6, groups=2),
    "stride2": dict(stride=2, dg=1),
    "dilation2": dict(dilation=2, padding=2),
    "groups2_stride2_nomask": dict(groups=2, stride=2, mask=False),
    "k5_p2": dict(k=5, padding=2),
    "kernel_shape": dict(),
    "kernel_shape_nomask": dict(mask=False, cout=10),
}


@pytest.mark.parametrize("name", list(CASES))
def test_modulated_deform_conv_matches_jax(name):
    """Forward and the gradients of x, offsets, mask, weight and bias
    against ``jax.vjp`` of JAX's columns form."""
    c = dict(CASES[name])
    k, s, p = c.get("k", 3), c.get("stride", 1), c.get("padding", 1)
    d, gr, dg = c.get("dilation", 1), c.get("groups", 1), c.get("dg", 2)
    x, off, m, wgt, bias, g = _inputs(0, **c)
    args = [x, off, m, wgt, bias]

    def jf(x_, o_, m_, w_, b_):
        return jdc.modulated_deform_conv(x_, o_, m_, w_, b_, s, p, d, gr, dg,
                                         impl="columns")

    live = [a is not None for a in args]
    jargs = [jnp.asarray(a) for a in args if a is not None]

    def jf_live(*xs):
        it = iter(xs)
        return jf(*[next(it) if l_ else None for l_ in live])

    ref, vjp = jax.vjp(jf_live, *jargs)
    jgrads = vjp(jnp.asarray(g))
    leaves = [None if a is None else
              (_oihw(a) if i == 3 else _t(a)).requires_grad_()
              for i, a in enumerate(args)]
    ours = modulated_deform_conv(leaves[0], leaves[1], leaves[2], leaves[3],
                                 leaves[4], s, p, d, dg, groups=gr)
    assert ours.shape == ref.shape
    _close(ours.detach().numpy(), ref)
    ours.backward(_t(g))
    got = [t.grad for t in leaves if t is not None]
    for i, (a, b_) in enumerate(zip(got, jgrads)):
        a = a.numpy()
        if a.ndim == 4 and i == len(got) - 2:   # the weight: OIHW -> HWIO
            a = a.transpose(2, 3, 1, 0)
        _close(a, b_, msg=f"grad {i}")


@pytest.mark.parametrize("k,stride,padding,groups",
                         [(3, 1, 0, 1), (3, 1, 1, 1), (3, 2, 1, 2),
                          (5, 1, 2, 1)])
def test_deform_conv_matches_jax(k, stride, padding, groups):
    x, off, _, wgt, _, _ = _inputs(1, k=k, stride=stride, padding=padding,
                                   groups=groups, dg=2)
    ref = jdc.deform_conv(jnp.asarray(x), jnp.asarray(off),
                          jnp.asarray(wgt), stride, padding, 1, groups, 2)
    ours = deform_conv(_t(x), _t(off), _oihw(wgt), stride, padding, 1,
                       groups, 2)
    assert ours.shape == ref.shape
    _close(ours.numpy(), ref)


@pytest.mark.parametrize("mask", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("k,stride,padding,dilation",
                         [(3, 1, 1, 1), (3, 2, 0, 1), (5, 1, 2, 2)])
def test_deform_conv_columns_match_jax(k, stride, padding, dilation, mask):
    """The columns, channel-major then tap, (B, Ho, Wo, Cin * K)."""
    x, off, m, *_ = _inputs(2, k=k, stride=stride, padding=padding,
                            dilation=dilation, mask=mask)
    ref = jdc.deform_conv_columns(
        jnp.asarray(x), jnp.asarray(off),
        None if m is None else jnp.asarray(m), (k, k), stride, padding,
        dilation, 2)
    ours = deform_conv_columns(_t(x), _t(off), None if m is None else _t(m),
                               (k, k), stride, padding, dilation, 2)
    assert ours.shape == ref.shape == (x.shape[0], *ref.shape[1:3], 8 * k * k)
    _close(ours.numpy(), ref)


def _jax_module_vs_port(jmod, port, seed, *inputs):
    variables = random_variables(jmod, np.random.default_rng(seed),
                                 *[jnp.asarray(a) for a in inputs])
    ref = jmod.apply(variables, *[jnp.asarray(a) for a in inputs])
    port.load_state_dict(state_dict_from_jax(variables["params"]),
                         strict=True)
    ours = port(*[_t(a) for a in inputs])
    assert ours.shape == ref.shape
    _close(ours.detach().numpy(), ref)


@pytest.mark.parametrize("case", ["self_offsets_k5_cout", "pcd_cout",
                                  "self_offsets_groups2"])
def test_dcnpack_matches_jax(case):
    """DCNPack's fields: offsets from x itself (``extra_offset_mask=False``)
    at kernel_size 5 and cout != cin; the PCD-align mode (offsets from a
    second tensor) at cout != cin; a grouped conv."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
    if case == "self_offsets_k5_cout":
        jmod = JaxDCNPack(24, kernel_size=5, padding=2, deformable_groups=4,
                          extra_offset_mask=False)
        port = DCNPack(16, 24, 4, kernel_size=5, padding=2,
                       extra_offset_mask=False)
        _jax_module_vs_port(jmod, port, 4, x)
    elif case == "pcd_cout":
        feat = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
        jmod = JaxDCNPack(8, deformable_groups=4)
        port = DCNPack(16, 8, 4)
        _jax_module_vs_port(jmod, port, 5, x, feat)
    else:
        jmod = JaxDCNPack(12, groups=2, deformable_groups=2,
                          extra_offset_mask=False)
        port = DCNPack(16, 12, 2, groups=2, extra_offset_mask=False)
        _jax_module_vs_port(jmod, port, 6, x)


@pytest.mark.parametrize("padding", [0, 1], ids=["p0", "p1"])
def test_deform_conv_module_matches_jax(padding):
    """DeformConvModule: external offsets, no bias, parameter ``weight``."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, 11, 16)).astype(np.float32)
    ho, wo = 9 - 2 * (1 - padding), 11 - 2 * (1 - padding)
    off = (rng.normal(size=(2, ho, wo, 4 * 18)) * 2).astype(np.float32)
    jmod = JaxDeformConv(12, padding=padding, deformable_groups=4)
    port = DeformConvModule(16, 12, padding=padding, deformable_groups=4)
    _jax_module_vs_port(jmod, port, 8, x, off)
    assert [k for k, _ in port.named_parameters()] == ["weight"]


@pytest.mark.parametrize("mask", [True, False], ids=["v2", "v1"])
@pytest.mark.parametrize("cin,cout,dg", [(16, 8, 4), (16, 24, 2)])
def test_plain_matches_jax_frame_path(cin, cout, dg, mask):
    """The plain op the kernels are held to, at cin != cout and with no
    mask, against JAX's frame path (the Pallas forward in interpret mode)
    at the same clamp, offsets on a 1/256-px grid inside it."""
    rng = np.random.default_rng(cin + cout + dg)
    b, h, w, r = 1, 16, 24, 3
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    off = (np.round(np.clip(rng.normal(size=(b, h, w, dg * 18)) * 2,
                            -r + .2, r - .2) * 256) / 256).astype(np.float32)
    m = rng.uniform(size=(b, h, w, dg * 9)).astype(np.float32) if mask \
        else None
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    ref = modulated_deform_conv_block(
        jnp.asarray(x), jnp.asarray(off),
        None if m is None else jnp.asarray(m), jnp.asarray(wgt),
        jnp.asarray(bias), 1, dg, max_offset=r, use_pallas="frame",
        pallas_interpret=True)
    ours = modulated_deform_conv_plain(
        _t(x), _t(off), None if m is None else _t(m), _oihw(wgt), _t(bias),
        1, 1, 1, dg, r)
    assert ours.shape == ref.shape == (b, h, w, cout)
    _close(ours.numpy(), ref, rel=5e-6)


def test_numpy_oracle_matches_jax_oracle():
    """``modulated_deform_conv_np`` (the port's copy, OIHW weights) against
    JAX's numpy oracle (HWIO) on a tiny grouped, strided input, float64,
    and against the port's op."""
    from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_np

    x, off, m, wgt, bias, _ = _inputs(9, cin=4, cout=4, dg=2, groups=2,
                                      stride=2, b=1, h=5, w=6)
    x, off, m, wgt, bias = (a.astype(np.float64)
                            for a in (x, off, m, wgt, bias))
    ref = jdc.modulated_deform_conv_np(x, off, m, wgt, bias, 2, 1, 1, 2, 2)
    ours = modulated_deform_conv_np(x, off, m, wgt.transpose(3, 2, 0, 1),
                                    bias, 2, 1, 1, 2, 2)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-12)
    op = modulated_deform_conv(*(_t(a) for a in (x, off, m)), _oihw(wgt),
                               _t(bias), 2, 1, 1, 2, groups=2)
    _close(op.numpy(), ours)
