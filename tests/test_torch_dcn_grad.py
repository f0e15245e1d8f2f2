"""DCN and conv3x3 gradients: the port vs the JAX package on the CPU.

The backward kernel's plain version (``dcn_bwd_plain``, autograd of the
plain DCN) against ``jax.vjp`` of the exact DCN (``impl="columns"``) and of
the JAX frame path's custom VJP (its Pallas backward kernel in interpret
mode), the clip gate, and the autograd Functions' own logic (activation
and bias undone from the saved output, then the backward kernel or the
conv's data and weight gradients), which run here on the plain versions
because the tensors lie on the CPU.

Inputs come from numpy seeds as float32; tolerances are stated per test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu.ops.deform_conv_block import modulated_deform_conv_block
from realvsr_tpu_torch.ops.deform_conv import (modulated_deform_conv,
                                               modulated_deform_conv_plain)
from realvsr_tpu_torch.ops.kernels.conv3x3 import (conv3x3_autograd,
                                                   conv3x3_plain)
from realvsr_tpu_torch.ops.kernels.dcn import (dcn_autograd, dcn_bwd,
                                               dcn_bwd_plain)

NAMES = ("dx", "doffset", "dmask", "dweight", "dbias")


def _inputs(seed, b=2, h=9, w=11, cin=16, cout=8, dg=2, off_scale=2.5,
            zero=False):
    """x, offset, mask, weight (HWIO), bias, cotangent.  Scale 2.5 px at
    these sizes puts many taps outside the image."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    off = (np.zeros((b, h, w, dg * 18), np.float32) if zero
           else (rng.normal(size=(b, h, w, dg * 18)) * off_scale
                 ).astype(np.float32))
    m = rng.uniform(size=(b, h, w, dg * 9)).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    return x, off, m, wgt, bias, g


def _leaves(x, off, m, wgt, bias):
    """Torch leaves (weight OIHW) that require grad."""
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in (x, off, m, wgt.transpose(3, 2, 0, 1), bias)]


def _port_grads(fn, args, g):
    leaves = _leaves(*args)
    out = fn(*leaves)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [t.numpy() for t in grads[:3]] + [
        grads[3].permute(2, 3, 1, 0).numpy(), grads[4].numpy()]


def _jax_grads(fn, args, g):
    _, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in args])
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _assert_close(ours, ref, rel):
    for name, a, b in zip(NAMES, ours, ref):
        assert a.shape == b.shape, name
        sc = max(1e-6, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, atol=rel * sc, err_msg=name)


@pytest.mark.parametrize("zero", [False, True], ids=["offsets", "on_grid"])
def test_plain_grads_match_jax_exact_dcn(zero):
    """Autograd of the port's op vs the JAX exact DCN's VJP, 1e-5 x the
    largest gradient (f32 sums in different orders).  At zero offsets every
    position is on the grid, where both take the one-sided difference
    v(y0 + 1) - v(y0)."""
    dg = 2
    args = _inputs(0, zero=zero)
    g = args[-1]
    ref = _jax_grads(
        lambda x, o, m, w, b: jdc.modulated_deform_conv(
            x, o, m, w, b, 1, 1, 1, 1, dg, impl="columns"), args[:5], g)
    ours = _port_grads(
        lambda x, o, m, w, b: modulated_deform_conv(
            x, o, m, w, b, deformable_groups=dg), args[:5], g)
    _assert_close(ours, ref, 1e-5)
    # dcn_bwd on CPU tensors is its plain version, and gives the same
    leaves = _leaves(*args[:5])
    four = dcn_bwd(*leaves[:4], torch.from_numpy(g), dg)
    for a, b in zip(four, dcn_bwd_plain(*leaves[:4], torch.from_numpy(g), dg)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for name, a, b in zip(NAMES, [t.numpy() for t in four[:3]]
                          + [four[3].permute(2, 3, 1, 0).numpy()], ours):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=name)


def _frame_inputs(seed, r, b=1, h=12, w=20, cin=16, dg=2):
    """Offsets inside the clamp, quantised to 1/256 px so the frame
    kernel's int16 fixed-point positions are exact (as
    tests/test_deform_conv.py holds that kernel)."""
    x, off, m, wgt, bias, g = _inputs(seed, b, h, w, cin, 8, dg)
    off = (np.round(np.clip(off * 0.8, -r + .2, r - .2) * 256) / 256
           ).astype(np.float32)
    return x, off, m, wgt, bias, g


def _frame_vjp(args, g, dg, r):
    return _jax_grads(
        lambda x, o, m, w, b: modulated_deform_conv_block(
            x, o, m, w, b, 1, dg, max_offset=r, use_pallas="frame",
            pallas_interpret=True), args, g)


def test_plain_grads_match_jax_frame_vjp():
    """The JAX frame path's custom VJP (``dcn_frame_fused_bwd`` in interpret
    mode, with its ``_fold_dpg`` / ``_fold_dcoord`` epilogues) vs the port
    at the same clamp, 5e-6 x the largest gradient."""
    dg, r = 2, 3
    args = _frame_inputs(5, r, dg=dg)
    ref = _frame_vjp(args[:5], args[-1], dg, r)
    ours = _port_grads(
        lambda x, o, m, w, b: modulated_deform_conv(
            x, o, m, w, b, deformable_groups=dg, max_offset=r),
        args[:5], args[-1])
    _assert_close(ours, ref, 5e-6)


def test_clip_gate_passes_on_the_closed_interval():
    """Offsets beyond ±R get no gradient, offsets of exactly ±R keep theirs
    (``jnp.clip``'s VJP in ``_fold_dcoord``); the port agrees with the JAX
    frame VJP on such offsets."""
    dg, r = 1, 2
    x, _, m, wgt, bias, g = _inputs(6, 1, 8, 8, 8, 8, dg)
    rng = np.random.default_rng(7)
    off = rng.choice(np.array([-5.0, -2.0, -1.5, 0.25, 1.0, 2.0, 3.5],
                              np.float32), size=(1, 8, 8, 18))
    ref = _frame_vjp((x, off, m, wgt, bias), g, dg, r)
    ours = _port_grads(
        lambda x_, o, m_, w_, b_: modulated_deform_conv(
            x_, o, m_, w_, b_, deformable_groups=dg, max_offset=r),
        (x, off, m, wgt, bias), g)
    doff = ours[1]
    assert not doff[np.abs(off) > r].any()
    assert np.abs(doff[np.abs(off) == r]).max() > 1e-3
    _assert_close(ours, ref, 5e-6)


@pytest.mark.parametrize("act", [None, "lrelu"])
@pytest.mark.parametrize("max_offset", [None, 2])
def test_dcn_function_matches_autograd_of_plain(act, max_offset):
    """The autograd Function's backward (activation undone from the saved
    output, ``dcn_bwd``, bias summed) vs autograd through the plain op with
    its fused bias and activation, at 1e-6 x the largest gradient."""
    dg = 2
    args = _inputs(8)
    leaves = _leaves(*args[:5])
    g = torch.from_numpy(args[-1])
    ref = torch.autograd.grad(
        modulated_deform_conv_plain(*leaves, 1, 1, 1, dg, max_offset, act),
        leaves, g)
    out = dcn_autograd(*leaves, dg, act, max_offset)
    torch.testing.assert_close(
        out, modulated_deform_conv_plain(*leaves, 1, 1, 1, dg, max_offset,
                                         act), rtol=0, atol=0)
    ours = torch.autograd.grad(out, leaves, g)
    for name, a, b in zip(NAMES, ours, ref):
        sc = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * sc, msg=name)


@pytest.mark.parametrize("act,residual,c2", [
    ("relu", False, 0), (None, True, 0), ("lrelu", False, 16)])
def test_conv3x3_function_matches_autograd_of_plain(act, residual, c2):
    """The conv3x3 Function's backward (the activation's slope from the
    output, data and weight gradients of the conv) vs autograd of the plain
    version, f32, 1e-5 x scale."""
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)
                                ).requires_grad_()

    x, w = t(2, 8, 12, 16), t(64, 16 + c2, 3, 3)
    bias = t(64)
    res = t(2, 8, 12, 64) if residual else None
    x2 = t(2, 8, 12, c2) if c2 else None
    g = torch.from_numpy(rng.normal(size=(2, 8, 12, 64)).astype(np.float32))
    leaves = [v for v in (x, w, bias, res, x2) if v is not None]
    ref = torch.autograd.grad(conv3x3_plain(x, w, bias, act, res, x2),
                              leaves, g)
    out = conv3x3_autograd(x, w, bias, act, res, x2)
    torch.testing.assert_close(out, conv3x3_plain(x, w, bias, act, res, x2),
                               rtol=0, atol=0)
    ours = torch.autograd.grad(out, leaves, g)
    for a, b in zip(ours, ref):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * b.abs().max().item())


def test_conv3x3_autograd_refuses_an_activation_with_a_residual():
    x = torch.zeros(1, 4, 4, 16)
    with pytest.raises(ValueError, match="residual"):
        conv3x3_autograd(x, torch.zeros(64, 16, 3, 3), act="relu",
                         residual=torch.zeros(1, 4, 4, 64))
