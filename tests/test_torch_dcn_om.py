"""DCNPack's offset/mask tensor read in place, and the DCN backward's tile
walk, on the CPU.

On the card the DCN kernels read DCNPack's ``conv_offset_mask`` output
``om`` (B, H, W, dg*27) as it lies: the offsets are its first dg*18
channels (concat(o1, o2) of the split), the mask the sigmoid of the rest,
and the backward writes one gradient of ``om``
(``realvsr_tpu_torch/ops/kernels/dcn.py``).  The kernels run only on the
card (``tests/test_torch_cuda.py``); here, from numpy seeds in f32, at
±4, ±8 and exact with the offset convs randomised:

* (a) the port's ``DCNPack`` (the plain ``om`` path) against the JAX
  ``DCNPack`` (stock XLA) from the same weights, and against the port's
  chunk / cat / sigmoid path, which it equals bit for bit;
* (b) the plain ``om`` backward (dx, the gradient of ``om``, dW) against
  ``jax.vjp`` of the JAX split / concat / sigmoid followed by the JAX exact
  DCN (its clip for ±R);
* (c) a numpy mirror of the backward kernel's walk (``csrc/dcn_bwd.cu``):
  each (group, tile) pair visited once; every corner of a ±R-clamped
  offset inside its tile's dx footprint; the corners outside it (no clamp,
  a clamp wider than the footprint) exactly those sent to the global path;
  and dx summed through footprints and that path equal to the plain dx.

Tolerances: 1e-5 x the largest magnitude of each result (f32 sums in other
orders), as the port's other DCN parity tests.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models.common import DCNPack as JaxDCNPack
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models.common import DCNPack
from realvsr_tpu_torch.ops.deform_conv import (modulated_deform_conv,
                                               modulated_deform_conv_om,
                                               split_om)
from realvsr_tpu_torch.ops.kernels import dcn

REL = 1e-5
RADII = [4, 8, None]


def _close(ours, ref, name=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    sc = max(1e-6, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=REL * sc, err_msg=name)


def _jax_split(om, dg, r):
    """The JAX DCNPack's split, concat and sigmoid (models/common.py), and
    the clip of the JAX ±R paths."""
    o1, o2, m = jnp.split(om, 3, axis=-1)
    off = jnp.concatenate([o1, o2], axis=-1)
    if r is not None:
        off = jnp.clip(off, -r, r)
    return off, jax.nn.sigmoid(m)


@pytest.fixture(scope="module")
def packs():
    """The JAX DCNPack (16 -> 16 channels, 2 groups) with its zero-initialised
    offset conv randomised, and the port's from the same weights."""
    rng = np.random.default_rng(0)
    cin, dg = 16, 2
    x = rng.normal(size=(2, 9, 13, cin)).astype(np.float32)
    feat = rng.normal(size=(2, 9, 13, cin)).astype(np.float32)
    jmod = JaxDCNPack(features=cin, deformable_groups=dg)
    params = jax.tree.map(np.asarray, jax.device_get(jmod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(feat))["params"]))
    conv = params["conv_offset_mask"]["Conv_0"]
    for name in ("kernel", "bias"):  # offsets of ~3 px: taps leave the image
        conv[name] = (rng.normal(size=conv[name].shape) * 0.4).astype(
            np.float32)
    params["bias"] = (rng.normal(size=params["bias"].shape) * 0.1).astype(
        np.float32)
    return x, feat, jmod, params, dg


def _port(params, dg, r):
    mod = DCNPack(16, 16, dg, r)
    mod.load_state_dict(state_dict_from_jax(params), strict=True)
    return mod.eval()


@pytest.mark.parametrize("r", RADII, ids=["r4", "r8", "exact"])
def test_dcnpack_om_matches_jax_and_the_split_path(packs, r):
    x, feat, jmod, params, dg = packs
    mod = _port(params, dg, r)
    xt, ft = torch.from_numpy(x), torch.from_numpy(feat)
    with torch.no_grad():
        om = mod.conv_offset_mask(ft)
        ours = mod(xt, ft)
        # today's chunk / cat / sigmoid path, as DCNPack ran it before
        o1, o2, m = torch.chunk(om, 3, dim=-1)
        split = modulated_deform_conv(
            xt, torch.cat([o1, o2], -1), torch.sigmoid(m).contiguous(),
            mod.weight, mod.bias, deformable_groups=dg, max_offset=r)
    assert om.shape == (2, 9, 13, 27 * dg)
    assert float(om[..., :18 * dg].abs().max()) > 4  # the clamps bite
    torch.testing.assert_close(ours, split, rtol=0, atol=0)
    off, mask = _jax_split(jnp.asarray(om.numpy()), dg, r)
    jw = jnp.asarray(params["weight"])
    ref = jdc.modulated_deform_conv(
        jnp.asarray(x), off, mask, jw, jnp.asarray(params["bias"]), 1, 1, 1,
        1, dg, impl="columns")
    _close(ours.numpy(), ref, "composed")
    if r is None:  # the JAX module itself
        whole = jmod.apply({"params": params}, jnp.asarray(x),
                           jnp.asarray(feat))
        _close(ours.numpy(), whole, "module")


@pytest.mark.parametrize("r", RADII, ids=["r4", "r8", "exact"])
def test_om_backward_plain_matches_jax_grad(r):
    """dcn_bwd_om_plain (what the backward kernel computes) against
    jax.vjp of split / concat / sigmoid + the exact DCN, and autograd of
    modulated_deform_conv_om on the CPU giving the same."""
    rng = np.random.default_rng(1 if r is None else r)
    b, h, w, cin, cout, dg = 2, 8, 11, 16, 16, 2
    x = rng.normal(size=(b, h, w, cin)).astype(np.float32)
    om = np.concatenate([rng.normal(size=(b, h, w, 18 * dg)) * 3,
                         rng.normal(size=(b, h, w, 9 * dg))], -1
                        ).astype(np.float32)
    wgt = (rng.normal(size=(3, 3, cin, cout)) * 0.3).astype(np.float32)
    g = rng.normal(size=(b, h, w, cout)).astype(np.float32)

    def f(x_, om_, w_):
        off, mask = _jax_split(om_, dg, r)
        return jdc.modulated_deform_conv(x_, off, mask, w_, None, 1, 1, 1, 1,
                                         dg, impl="columns")

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(om), jnp.asarray(wgt))
    ref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    wt = torch.from_numpy(np.ascontiguousarray(wgt.transpose(3, 2, 0, 1)))
    dx, dom, dw = dcn.dcn_bwd_om_plain(
        torch.from_numpy(x), torch.from_numpy(om), wt, torch.from_numpy(g),
        dg, r)
    assert dom.shape == om.shape
    _close(dx, ref[0], "dx")
    _close(dom, ref[1], "dom")
    _close(dw.permute(2, 3, 1, 0), ref[2], "dweight")
    if r is not None:  # the clamp's gate
        assert not dom[..., :18 * dg][torch.from_numpy(
            np.abs(om[..., :18 * dg]) > r)].any()
    # the entry DCNPack calls: on CPU tensors, autograd of the plain op
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, om)]
    out = modulated_deform_conv_om(leaves[0], leaves[1], wt, None, dg, r)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    for a, b_ in zip(grads, (dx, dom)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    # and dcn_bwd_om on CPU tensors is its plain version
    for a, b_ in zip(dcn.dcn_bwd_om(torch.from_numpy(x), torch.from_numpy(om),
                                    wt, torch.from_numpy(g), dg, r),
                     (dx, dom, dw)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_om_forward_plain_is_the_split_forward():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 6, 7, 64)).astype(np.float32))
    om = torch.from_numpy(rng.normal(size=(1, 6, 7, 216)).astype(np.float32)
                          * 2)
    w = torch.from_numpy(rng.normal(size=(64, 64, 3, 3)).astype(np.float32)
                         * 0.05)
    off, mask = split_om(om, 8)
    torch.testing.assert_close(
        dcn.dcn_fwd_om(x, om, w, None, 8, "lrelu", 4),
        dcn.dcn_fwd(x, off, mask, w, None, 8, "lrelu", 4), rtol=0, atol=0)


# ---------------------------------------------------------------- (c)


def _walk(shape, off, r, th):
    """Every valid corner of every (pixel, group, tap) of the backward with
    tiles of ``th`` rows, as the kernel routes it: arrays of the pixel it
    comes from, group, tap, its tile, corner pixel (b, y, x), bilinear
    weight and whether it lies in its tile's footprint.  Positions in f32,
    as the kernel takes them."""
    b, h, w = shape
    rf = dcn.footprint_radius(r)
    tw = dcn.BWD_TW
    tiles_y, tiles_x = -(-h // th), -(-w // tw)
    bi, yi, xi = np.meshgrid(np.arange(b), np.arange(h), np.arange(w),
                             indexing="ij")
    o = off.reshape(b, h, w, 8, 9, 2).astype(np.float32)
    if r is not None:
        o = np.clip(o, np.float32(-r), np.float32(r))
    taps = np.arange(9)
    py = (yi[..., None, None] - 1 + taps // 3).astype(np.float32) + o[..., 0]
    px = (xi[..., None, None] - 1 + taps % 3).astype(np.float32) + o[..., 1]
    fy, fx = np.floor(py), np.floor(px)
    ty, tx = py - fy, px - fx
    tile = (bi * tiles_y + yi // th) * tiles_x + xi // tw
    fy0 = (yi // th) * th - 1 - rf
    fx0 = (xi // tw) * tw - 1 - rf
    _, _, fh, fw = dcn.footprint(0, 0, rf, th)
    rows = []
    for k, (dyk, dxk, wk) in enumerate((
            (0, 0, (1 - ty) * (1 - tx)), (0, 1, (1 - ty) * tx),
            (1, 0, ty * (1 - tx)), (1, 1, ty * tx))):
        cy, cx = fy + dyk, fx + dxk
        valid = (cy >= 0) & (cy <= h - 1) & (cx >= 0) & (cx <= w - 1)
        ry = cy - fy0[..., None, None]
        rx = cx - fx0[..., None, None]
        inside = (ry >= 0) & (ry < fh) & (rx >= 0) & (rx < fw)
        idx = np.nonzero(valid)
        rows.append(dict(
            src=idx[:3], group=idx[3], tap=idx[4],
            tile=tile[idx[:3]], b=bi[idx[:3]],
            cy=cy[idx].astype(np.int64), cx=cx[idx].astype(np.int64),
            w=wk[idx], inside=inside[idx]))
    return {key: np.concatenate([rw[key] for rw in rows]) if key != "src"
            else tuple(np.concatenate([rw["src"][i] for rw in rows])
                       for i in range(3))
            for key in rows[0]}


@pytest.mark.parametrize("hw", [(13, 45), (16, 64)], ids=["ragged", "even"])
def test_bwd_walk_visits_each_group_tile_once(hw):
    h, w = hw
    for dtype in (torch.bfloat16, torch.float32):
        th = dcn.TILE_ROWS[dtype]
        ntiles = 2 * -(-h // th) * -(-w // dcn.BWD_TW)
        grid = dcn.bwd_grid(2, h, w, 132, dtype)
        pairs = [(g, t) for g, tiles in grid for t in tiles]
        assert len(pairs) == len(set(pairs)) == 8 * ntiles
        assert len(grid) % 8 == 0
        # the 8 groups of a tile run side by side: blocks 8j ... 8j + 7
        for j in range(0, len(grid), 8):
            assert [grid[j + i][0] for i in range(8)] == list(range(8))
            assert all(grid[j + i][1] == grid[j][1] for i in range(8))
    for dtype in (torch.bfloat16, torch.float32):
        assert dcn.fwd_smem_bytes(dtype) <= 232448
        for r in (None, 0.5, 4, 4.5, 8, 12):
            assert dcn.bwd_smem_bytes(dtype, dcn.footprint_radius(r)) \
                <= 232448


@pytest.mark.parametrize("th", sorted(set(dcn.TILE_ROWS.values())),
                         ids=lambda t: f"rows{t}")
@pytest.mark.parametrize("r,std", [(4, 2.5), (8, 4.0), (4.5, 3.0),
                                   (None, 2.5), (None, 12.0), (12, 12.0)],
                         ids=["r4", "r8", "r4.5", "exact", "exact_far",
                              "r12_far"])
def test_bwd_footprint_routes_and_sums_dx(r, std, th):
    """Clamped to R <= 8 every corner lies in its tile's footprint; with no
    clamp, or R beyond the radius of 8, the corners outside it go to the
    global path, and with offsets of std 12 some do; dx summed per tile's
    footprint (flushed) plus the global path equals the plain dx.  Tiles of
    16 rows (bf16) and 8 (f32), ragged against 13 x 45."""
    rng = np.random.default_rng(int(std * 10) + (0 if r is None else 1))
    b, h, w, c = 2, 13, 45, 64
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 144)) * std).astype(np.float32)
    mask = rng.uniform(size=(b, h, w, 72)).astype(np.float32)
    wgt = (rng.normal(size=(64, c, 3, 3)) * 0.05).astype(np.float32)
    g = rng.normal(size=(b, h, w, 64)).astype(np.float32)
    wk = _walk((b, h, w), off, r, th)
    if r is not None and math.ceil(r) <= dcn.RF_MAX:
        assert wk["inside"].all()
    if std > dcn.RF_MAX:
        assert not wk["inside"].all()
    # dS * mask per (pixel, group, tap, channel), f32 as in the plain op
    ds = np.einsum("bhwo,oqit->bhwqti", g, wgt.reshape(64, 8, 8, 9))
    dv = ds * mask.reshape(b, h, w, 8, 9)[..., None]
    src = wk["src"]
    contrib = dv[src + (wk["group"], wk["tap"])] * wk["w"][:, None]
    dx = np.zeros((b, h, w, 8, 8), np.float64)
    # the global path: corners outside their footprint, straight into dx
    out = ~wk["inside"]
    np.add.at(dx, (wk["b"][out], wk["cy"][out], wk["cx"][out],
                   wk["group"][out]), contrib[out])
    # per (tile, group): the footprint, then its flush into dx
    rf = dcn.footprint_radius(r)
    tw = dcn.BWD_TW
    tiles_x = -(-w // tw)
    for tile in np.unique(wk["tile"]):
        tb, rest = divmod(int(tile), -(-h // th) * tiles_x)
        y0, x0, fh, fw = dcn.footprint(rest // tiles_x * th,
                                       rest % tiles_x * tw, rf, th)
        sel = wk["inside"] & (wk["tile"] == tile)
        fp = np.zeros((fh, fw, 8, 8))
        np.add.at(fp, (wk["cy"][sel] - y0, wk["cx"][sel] - x0,
                       wk["group"][sel]), contrib[sel])
        ys, xs = np.nonzero(np.abs(fp).sum((2, 3)))
        assert ((ys + y0 >= 0) & (ys + y0 < h) & (xs + x0 >= 0)
                & (xs + x0 < w)).all()  # only pixels of the image flush
        np.add.at(dx, (tb, ys + y0, xs + x0), fp[ys, xs])
    ref = dcn.dcn_bwd_plain(
        *(torch.from_numpy(a) for a in (x, off, mask, wgt, g)), 8, r)[0]
    _close(dx.reshape(b, h, w, 64), ref.numpy(), "dx")
