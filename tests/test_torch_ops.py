"""Port ops vs the JAX package on the CPU: DCN, conv3x3, resize, and the
host-side copies (indexing, color, metrics, image IO).

Inputs come from numpy seeds and go to both packages as float32.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu.ops.deform_conv_block import modulated_deform_conv_block
from realvsr_tpu.ops.pallas.conv3x3_kernel import (
    conv3x3_packed, pack_pairs, unpack_pairs)
from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv
from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3
from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


def _dcn_inputs(seed, b=2, h=9, w=11, cin=8, cout=6, dg=2, k=3, ho=None,
                wo=None, off_scale=2.5):
    rng = np.random.default_rng(seed)
    ho, wo = ho or h, wo or w
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    # scale 2.5 px at these sizes puts many taps outside the image
    off = (rng.normal(size=(b, ho, wo, dg * k * k * 2)) * off_scale
           ).astype(np.float32)
    m = rng.uniform(size=(b, ho, wo, dg * k * k)).astype(np.float32)
    wgt = (rng.normal(size=(k, k, cin, cout)) * 0.3).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    return x, off, m, wgt, bias


@pytest.mark.parametrize("case", [
    dict(),
    dict(dg=4, cin=16),
    dict(dg=1, stride=2, ho=5, wo=6),
    dict(padding=0, ho=7, wo=9),
    dict(dilation=2, padding=2),
    dict(mask=False),
])
def test_dcn_plain_matches_jax_columns(case):
    case = dict(case)
    stride = case.pop("stride", 1)
    padding = case.pop("padding", 1)
    dilation = case.pop("dilation", 1)
    use_mask = case.pop("mask", True)
    dg = case.get("dg", 2)
    x, off, m, wgt, bias = _dcn_inputs(0, **case)
    m = m if use_mask else None
    ref = jdc.modulated_deform_conv(
        jnp.asarray(x), jnp.asarray(off), None if m is None else jnp.asarray(m),
        jnp.asarray(wgt), jnp.asarray(bias), stride, padding, dilation, 1, dg,
        impl="columns")
    ours = modulated_deform_conv(
        _t(x), _t(off), None if m is None else _t(m), _oihw(wgt), _t(bias),
        stride, padding, dilation, dg)
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5)


def test_dcn_out_of_image_taps_are_zero_padded():
    """Offsets that push every tap far outside the image sample zeros."""
    x, off, m, wgt, bias = _dcn_inputs(1)
    off = np.full_like(off, 50.0)
    out = modulated_deform_conv(_t(x), _t(off), _t(m), _oihw(wgt), _t(bias),
                                deformable_groups=2)
    np.testing.assert_allclose(out.numpy(),
                               np.broadcast_to(bias, out.shape), atol=1e-6)


@pytest.mark.parametrize("act", [None, "lrelu"])
def test_dcn_clamped_matches_jax_block(act):
    r = 3
    x, off, m, wgt, bias = _dcn_inputs(2, b=2, h=12, w=20, cin=16, cout=8,
                                       dg=4, off_scale=2.0)
    assert (np.abs(off) > r).any()  # the clamp is exercised
    ref = modulated_deform_conv_block(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(m), jnp.asarray(wgt),
        jnp.asarray(bias), 1, 4, max_offset=r)
    ref = np.asarray(ref)
    if act == "lrelu":
        ref = np.where(ref >= 0, ref, 0.1 * ref)
    ours = dcn_fwd(_t(x), _t(off), _t(m), _oihw(wgt), _t(bias), 4, act=act,
                   max_offset=r)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_dcn_clamped_matches_jax_frame_kernel_interpret():
    """Against the TPU frame kernel (Pallas interpret mode) on the inputs of
    tests/test_deform_conv.py test_frame_dma_kernel_matches_xla_block
    (offsets inside ±R): its int16 fixed-point positions bound the error at
    8e-3."""
    rng = np.random.default_rng(32)
    b, h, w, cin, dg, r = 2, 24, 40, 16, 4, 3
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    off = np.clip(rng.normal(size=(b, h, w, dg * 9 * 2)) * 2, -r + .2,
                  r - .2).astype(np.float32)
    m = rng.uniform(size=(b, h, w, dg * 9)).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, 8)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(8,)).astype(np.float32)
    ref = modulated_deform_conv_block(
        jnp.asarray(x), jnp.asarray(off), jnp.asarray(m), jnp.asarray(wgt),
        jnp.asarray(bias), 1, dg, max_offset=r, use_pallas="frame",
        pallas_interpret=True)
    ours = dcn_fwd(_t(x), _t(off), _t(m), _oihw(wgt), _t(bias), dg,
                   max_offset=r)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=8e-3)


@pytest.mark.parametrize("act,residual,concat", [
    (None, False, False),
    ("relu", False, False),
    (None, True, False),
    ("relu", True, False),
    ("lrelu", False, True),
    ("lrelu", True, True),
])
def test_conv3x3_plain_matches_packed_kernel_interpret(act, residual, concat):
    rng = np.random.default_rng(4)
    b, h, w, c1, c2, cout = 2, 8, 16, 16, 16 if concat else 0, 32
    x1 = rng.normal(size=(b, h, w, c1)).astype(np.float32)
    x2 = rng.normal(size=(b, h, w, c2)).astype(np.float32) if concat else None
    wgt = (rng.normal(size=(3, 3, c1 + c2, cout)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    res = (rng.normal(size=(b, h, w, cout)).astype(np.float32)
           if residual else None)
    xp = pack_pairs(jnp.asarray(x1))
    if concat:
        xp = jnp.concatenate([xp, pack_pairs(jnp.asarray(x2))], axis=-1)
    ref = conv3x3_packed(
        xp, jnp.asarray(wgt), jnp.asarray(bias), h=h, act=act,
        residual=None if res is None else pack_pairs(jnp.asarray(res)),
        splits=(c1, c2) if concat else None, interpret=True)
    ref = np.asarray(unpack_pairs(ref))
    ours = conv3x3(_t(x1), _oihw(wgt), _t(bias), act,
                   None if res is None else _t(res),
                   None if x2 is None else _t(x2))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5)


def test_wrappers_use_plain_version_on_cpu_only():
    """A CPU tensor runs the plain version and counts no launch; a tensor
    on a device with no kernel raises instead of falling back."""
    x, off, m, wgt, bias = _dcn_inputs(5, cin=16, cout=64, dg=2)
    n_dcn, n_conv = dcn_fwd.launches, conv3x3.launches
    dcn_fwd(_t(x), _t(off), _t(m), _oihw(wgt), _t(bias), 2)
    conv3x3(_t(x), _oihw(np.zeros((3, 3, 16, 64), np.float32)))
    assert (dcn_fwd.launches, conv3x3.launches) == (n_dcn, n_conv)
    meta = torch.empty(1, 8, 8, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        conv3x3(meta, torch.empty(64, 16, 3, 3, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        dcn_fwd(meta, meta, meta, torch.empty(64, 16, 3, 3, device="meta"))


@pytest.mark.parametrize("shape,out_hw", [
    ((2, 5, 7, 4), (10, 14)),
    ((1, 3, 4, 6, 3), (6, 8)),
    ((2, 6, 5, 3), (9, 13)),
])
def test_resize_bilinear_matches_jax(shape, out_hw):
    from realvsr_tpu.ops.resize import resize_bilinear as jresize
    from realvsr_tpu_torch.ops.resize import resize_bilinear

    x = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    ref = np.asarray(jresize(jnp.asarray(x), out_hw))
    np.testing.assert_allclose(resize_bilinear(_t(x), out_hw).numpy(), ref,
                               atol=1e-5)


def test_upsample2x_and_pixel_shuffle_match_jax():
    from realvsr_tpu.ops import resize as jr
    from realvsr_tpu_torch.ops import resize as tr

    x = np.random.default_rng(7).normal(size=(2, 6, 5, 12)).astype(np.float32)
    np.testing.assert_allclose(
        tr.upsample2x_bilinear(_t(x)).numpy(),
        np.asarray(jr.upsample2x_bilinear(jnp.asarray(x))), atol=1e-5)
    x18 = np.random.default_rng(7).normal(size=(1, 2, 3, 4, 18)).astype(
        np.float32)
    for a, r in ((x, 2), (x18, 3)):
        np.testing.assert_array_equal(
            tr.pixel_shuffle(_t(a), r).numpy(),
            np.asarray(jr.pixel_shuffle(jnp.asarray(a), r)))
    # against torch's own NCHW PixelShuffle
    ps = torch.nn.PixelShuffle(2)(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(tr.pixel_shuffle(_t(x), 2).numpy(),
                                  ps.numpy())


@pytest.mark.parametrize("padding", ["replicate", "reflection", "new_info",
                                     "circle"])
def test_index_generation_matches_jax_package(padding):
    from realvsr_tpu.utils.indexing import index_generation as jidx
    from realvsr_tpu_torch.utils.indexing import index_generation

    for n in (3, 5, 7):
        for i in range(9):
            assert index_generation(i, 9, n, padding) == jidx(i, 9, n, padding)


def test_color_and_metrics_match_jax_package():
    from realvsr_tpu.ops import color as jc, metrics as jm
    from realvsr_tpu_torch.ops import color as tc, metrics as tm

    rng = np.random.default_rng(8)
    f = rng.random((20, 24, 3))
    u = rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
    for img in (f, u):
        np.testing.assert_array_equal(tc.rgb2ycbcr_np(img), jc.rgb2ycbcr_np(img))
        np.testing.assert_array_equal(tc.bgr2ycbcr_np(img, only_y=True),
                                      jc.bgr2ycbcr_np(img, only_y=True))
        np.testing.assert_array_equal(tc.ycbcr2bgr_np(img), jc.ycbcr2bgr_np(img))
    v = rng.integers(0, 256, size=(20, 24, 3), dtype=np.uint8)
    assert tm.calculate_psnr_np(u, v) == jm.calculate_psnr_np(u, v)
    assert tm.calculate_ssim_np(u, v) == jm.calculate_ssim_np(u, v)
    assert tm.calculate_ssim_np(u[..., 0], v[..., 0]) == \
        jm.calculate_ssim_np(u[..., 0], v[..., 0])


def test_imageio_matches_jax_package(tmp_path):
    from realvsr_tpu.data import imageio as jio
    from realvsr_tpu_torch.data import imageio as tio

    rng = np.random.default_rng(9)
    for t in range(3):
        tio.write_img(str(tmp_path / "clip" / f"{t:05d}.png"),
                      rng.random((12, 16, 3)).astype(np.float32))
    for color in (None, "y"):
        np.testing.assert_array_equal(
            tio.read_img_seq(str(tmp_path / "clip"), color=color),
            jio.read_img_seq(str(tmp_path / "clip"), color=color))


def test_config_parse_matches_jax_package():
    from realvsr_tpu.core.config import parse as jparse
    from realvsr_tpu_torch.core.config import parse

    path = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                        "test", "test_EDVR_woTSA_RealVSR_wi_GT.yml")
    a, b = parse(path, is_train=False, root="/r"), jparse(path, is_train=False,
                                                          root="/r")
    assert a == b and a["network_G"]["which_model_G"] == "EDVR_NoUp"
    assert a["path"]["missing_key"] is None
