"""The DCN at the widths beside (64, 8) and (16, 4), on the CPU: EDVR-L's 128
channels in 8 deformable groups (``csrc/dcn_fwd.cu`` / ``dcn_bwd.cu``) and
the narrow kernels' other cases (``csrc/dcn_narrow.cu``: 32 in 4 or 8, 48
in 8, 64 in 4).

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here, from numpy seeds in f32:

* (a) the plain forward and backward at each width, separate and in-place
  ``om`` forms, against the JAX package's exact DCN and ``jax.vjp`` of it,
  exact and at ±4 / ±8 (JAX's offsets clipped to ±R; no offset gradient
  beyond the clamp);
* (b) the widths the wrappers route to each design and refuse;
* (c) the shared memory of every width against the card's 232448 bytes a
  block, with the sizes of ``dcn_fwd.cu``'s ``Shape`` and ``dcn_bwd.cu``'s
  ``Layout`` worked out by hand; the 128-channel backward's walk (each
  (group, tile) once, tiles of 4 rows) and its dx, summed per tile's
  16-channel footprint plus the global path, against the plain dx.

Tolerances: 1e-5 x the largest magnitude of each result (f32 sums in other
orders), as the port's other DCN parity tests.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu_torch.ops.deform_conv import split_om
from realvsr_tpu_torch.ops.kernels import dcn
from test_torch_dcn_om import _walk

REL = 1e-5
WIDTHS = [(128, 8), (32, 4), (32, 8), (48, 8), (64, 4)]
RADII = [4, 8, None]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(ours, ref, name=""):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, name
    sc = max(1e-6, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours, ref, atol=REL * sc, err_msg=name)


def _inputs(seed, c, dg, shape=(2, 7, 9)):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    # offsets of std 3 px: taps leave the image, some beyond ±8
    om = np.concatenate([rng.normal(size=(b, h, w, 18 * dg)) * 3,
                         rng.normal(size=(b, h, w, 9 * dg))], -1
                        ).astype(np.float32)
    wgt = (rng.normal(size=(c, c, 3, 3)) / np.sqrt(9 * c)).astype(np.float32)
    bias = (rng.normal(size=c) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, om, wgt, bias, g


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("r", RADII, ids=["r4", "r8", "exact"])
@pytest.mark.parametrize("c,dg", WIDTHS,
                         ids=[f"C{c}_dg{g}" for c, g in WIDTHS])
def test_plain_dcn_matches_jax_at_width(c, dg, r):
    x, om, wgt, bias, g = _inputs(c + dg + (0 if r is None else r), c, dg)
    xt, omt, wt, bt, gt = (torch.from_numpy(a) for a in (x, om, wgt, bias,
                                                         g))
    off, mask = split_om(omt, dg)
    joff = jnp.asarray(off.numpy())
    if r is not None:
        joff = jnp.clip(joff, -r, r)
    jw = jnp.asarray(wgt.transpose(2, 3, 1, 0))

    def f(x_, off_, mask_, w_):
        return jdc.modulated_deform_conv(x_, off_, mask_, w_, None, 1, 1, 1,
                                         1, dg, impl="columns")

    ref, vjp = jax.vjp(f, jnp.asarray(x), joff, jnp.asarray(mask.numpy()),
                      jw)
    off, mask = off.contiguous(), mask.contiguous()
    _close(dcn.dcn_fwd(xt, off, mask, wt, None, dg, None, r), ref, "forward")
    _close(dcn.dcn_fwd_om(xt, omt, wt, bt, dg, "lrelu", r),
           dcn.dcn_fwd(xt, off, mask, wt, bt, dg, "lrelu", r), "om forward")
    dref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    dx, doff, dmask, dw = dcn.dcn_bwd(xt, off, mask, wt, gt, dg, r)
    _close(dx, dref[0], "dx")
    if r is not None:  # the clamp's gate: no gradient beyond ±R
        dref[1] = np.where(np.abs(off.numpy()) <= r, dref[1], 0)
    _close(doff, dref[1], "doffset")
    _close(dmask, dref[2], "dmask")
    _close(dw.permute(2, 3, 1, 0), dref[3], "dweight")
    dx2, dom, dw2 = dcn.dcn_bwd_om(xt, omt, wt, gt, dg, r)
    torch.testing.assert_close(dx2, dx, rtol=0, atol=0)
    torch.testing.assert_close(dw2, dw, rtol=0, atol=0)
    assert dom.shape == om.shape


# ---------------------------------------------------------------- (b)


def test_route_takes_each_design_and_refuses_the_rest():
    """The kernels' domain is the TPU kernel's: the wgmma pair at 64 -> 64
    and 128 -> 128 in 8 groups with a mask; ``dcn_narrow.cu`` at every
    other shape (cin != cout, any width, no mask); a ValueError only where
    the groups do not divide the input channels, which JAX cannot run."""
    assert dcn.route(64, 64, 8) == dcn.route(128, 128, 8) == "wgmma"
    assert dcn.route(64) == dcn.route(64, dg=8) == "wgmma"
    for c, dg in ((16, 4), (32, 4), (32, 8), (48, 8), (64, 4), (64, 1),
                  (64, 64), (24, 3), (8, 8), (1, 1), (256, 8), (128, 4),
                  (96, 8), (128, 16), (72, 8), (96, 4)):
        assert dcn.route(c, c, dg) == "narrow", (c, dg)
    for cin, cout, dg in ((64, 32, 8), (32, 64, 8), (128, 64, 8),
                          (64, 128, 8), (400, 24, 8), (6, 10, 3)):
        assert dcn.route(cin, cout, dg) == "narrow", (cin, cout)
    for c in (16, 64, 128, 256):   # DCNv1: no mask, never the wgmma pair
        assert dcn.route(c, c, 8, has_mask=False) == "narrow"
    for cin, cout, dg in ((48, 48, 5), (0, 1, 1), (64, 64, 0), (10, 10, 3),
                          (64, 0, 8)):
        with pytest.raises(ValueError, match="groups must divide"):
            dcn.route(cin, cout, dg)


def _bwd_chunks(cin, cout, dg):
    """``dcn_narrow.cu::bwd_kernel``'s walk of one tap: for each chunk of
    input channels, its (group, first channel, end) parts."""
    kc, _, _ = dcn.narrow_bwd_plan(cin, cout, dg)
    cpg = cin // dg
    return [[(g, max(g * cpg, k0), min(g * cpg + cpg, k0 + kc))
             for g in range(k0 // cpg, (min(k0 + kc, cin) - 1) // cpg + 1)]
            for k0 in range(0, cin, kc)]


@pytest.mark.parametrize("cin,cout,dg", [
    (16, 16, 4), (64, 64, 4), (64, 32, 8), (32, 64, 8), (96, 96, 4),
    (256, 256, 8), (128, 64, 8), (400, 24, 8), (6, 10, 3), (256, 256, 1),
    (200, 8, 1)])
def test_narrow_plans_cover_each_channel_once_and_fit(cin, cout, dg):
    """The generalised kernels' plans (``narrow_fwd_plan`` /
    ``narrow_bwd_plan``, copies of ``fwd_plan`` / ``bwd_plan``): the
    forward's output tiles cover cout once in whole 16-output chunks; the
    backward's chunks take each input channel of a tap once, each chunk
    whole groups or an equal part of one group, in whole CH-channel loads;
    both within shared memory, the C -> C <= 64 forms as before (whole
    weight, whole g row)."""
    cot, ntap = dcn.narrow_fwd_plan(cin, cout)
    assert cot % dcn.NARROW_CO == 0 and ntap in (1, 9)
    assert (ntap * cin * cot + cot) * 4 <= 232448
    if ntap == 1:
        assert cot == dcn.NARROW_CO and (9 * cin * 16 + 16) * 4 > \
            dcn.NARROW_FWD_BUDGET
    tiles = range(0, cout, cot)
    assert sorted(c for t in tiles for c in range(t, min(t + cot, cout))) \
        == list(range(cout))
    kc, ko, one_co = dcn.narrow_bwd_plan(cin, cout, dg)
    cpg = cin // dg
    ch = dcn._chunk_of(cpg)
    assert kc % ch == 0 and (kc % cpg == 0 or cpg % kc == 0 or kc == cin)
    parts = [p for chunk in _bwd_chunks(cin, cout, dg) for p in chunk]
    assert sorted(c for _, lo, hi in parts for c in range(lo, hi)) == \
        list(range(cin))
    for g, lo, hi in parts:
        assert g * cpg <= lo < hi <= g * cpg + cpg and (lo - g * cpg) % ch == 0
    assert dcn.bwd_smem_bytes(torch.float32, 8, cin, dg, cout, False) \
        <= 232448
    assert one_co == (ko == cout)
    if cin == cout <= 64:
        assert (cot, ntap, kc, one_co) == (-(-cout // 16) * 16, 9, cin, True)


# ---------------------------------------------------------------- (c)


def test_shared_memory_of_every_width_fits_a_block():
    """Worked out from the sources' layouts: the 128-channel forward holds
    a two-tap weight ring (2 x chunks x 128 rows x 128 B) and two A stages
    of TH x 16 pixels; the backward a two-tap ring of the group's 16 x
    (128 + pad) weight, the g tile, dS (f32), two S buffers, one f32 a warp
    and the footprint of 17 ints a pixel."""
    bf, f32 = torch.bfloat16, torch.float32
    assert (dcn.tile_rows(bf, 128), dcn.tile_rows(f32, 128)) == (8, 4)
    assert dcn.tile_rows(bf, 128, bwd=True) == 4
    assert dcn.tile_rows(f32, 128, bwd=True) == 4
    assert dcn.fwd_smem_bytes(bf, 128, 8) == 2 * 2 * 128 * 128 + 2 * (
        2 * 8 * 16 * 128)                                        # 128 KB
    assert dcn.fwd_smem_bytes(f32, 128, 8) == 2 * 4 * 128 * 128 + 2 * (
        4 * 4 * 16 * 128)                                        # 192 KB
    fp4 = (4 + 19) * (32 + 19) * 17 * 4
    assert dcn.bwd_smem_bytes(bf, 8, 128, 8) == (
        2 * 16 * 136 * 2 + 128 * 136 * 2 + 128 * 16 * 4
        + 2 * 16 * 136 * 2 + 8 * 4 + fp4)                       # 140212
    assert dcn.bwd_smem_bytes(f32, 8, 128, 8) == (
        2 * 16 * 132 * 4 + 128 * 132 * 4 + 128 * 16 * 4
        + 2 * 16 * 132 * 4 + 8 * 4 + fp4)                       # 189364
    # the 64-wide ones as they were
    assert dcn.fwd_smem_bytes(bf) == 9 * 64 * 128 + 2 * 256 * 128
    assert dcn.fwd_smem_bytes(f32) == 9 * 2 * 64 * 128 + 2 * 2 * 128 * 128
    for dtype in (bf, f32):
        for c, dg in WIDTHS + [(64, 8), (16, 4), (64, 1), (24, 3)]:
            assert dcn.fwd_smem_bytes(dtype, c, dg) <= 232448, (c, dg)
            for r in (None, 0.5, 4, 8, 12):
                assert dcn.bwd_smem_bytes(
                    dtype, dcn.footprint_radius(r), c, dg) <= 232448
    # the narrow kernels: one block an SM at 64 channels, 4 at 16
    assert dcn.narrow_blocks_per_sm(64) == 1
    assert dcn.narrow_blocks_per_sm(32) == 3
    assert dcn.narrow_blocks_per_sm(16) == 4
    # the widened domain: every shape fits a block, 256 -> 256 in 8 groups
    # in the chunked backward (2 blocks an SM) and a 16-output forward tile
    for dtype in (bf, f32):
        for cin, cout, dg in ((64, 32, 8), (32, 64, 8), (96, 96, 4),
                              (256, 256, 8), (128, 64, 8), (400, 24, 8)):
            for m in (True, False):
                assert dcn.fwd_smem_bytes(dtype, cin, dg, cout, m) <= 232448
                assert dcn.bwd_smem_bytes(dtype, 8, cin, dg, cout, m) <= \
                    232448
    assert dcn.narrow_fwd_plan(256, 256) == (16, 9)
    assert dcn.narrow_bwd_plan(256, 256, 8) == (32, 32, False)
    assert dcn.narrow_blocks_per_sm(256, 256, 8) == 2
    assert dcn.narrow_fwd_plan(400, 24) == (16, 1)


@pytest.mark.parametrize("hw", [(13, 45), (16, 64)], ids=["ragged", "even"])
def test_bwd_128_walk_visits_each_group_tile_once(hw):
    h, w = hw
    for dtype in (torch.bfloat16, torch.float32):
        th = dcn.tile_rows(dtype, 128, bwd=True)
        ntiles = 2 * -(-h // th) * -(-w // dcn.BWD_TW)
        grid = dcn.bwd_grid(2, h, w, 132, dtype, 128, 8)
        pairs = [(g, t) for g, tiles in grid for t in tiles]
        assert len(pairs) == len(set(pairs)) == 8 * ntiles
        for j in range(0, len(grid), 8):
            assert [grid[j + i][0] for i in range(8)] == list(range(8))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("r,std", [(8, 4.0), (4.5, 3.0), (None, 12.0)],
                         ids=["r8", "r4.5", "exact_far"])
def test_bwd_128_footprint_routes_and_sums_dx(r, std, dtype):
    """At 128 channels (16 a group) and tiles of 4 rows:
    clamped to R <= 8 every corner lies in its tile's footprint, with no
    clamp some do not; dx summed per tile's 16-channel footprint (flushed)
    plus the global path equals the plain dx."""
    rng = np.random.default_rng(int(std * 10) + (0 if r is None else 1))
    b, h, w, c, cpg = 1, 13, 45, 128, 16
    th = dcn.tile_rows(dtype, c, bwd=True)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    off = (rng.normal(size=(b, h, w, 144)) * std).astype(np.float32)
    mask = rng.uniform(size=(b, h, w, 72)).astype(np.float32)
    wgt = (rng.normal(size=(c, c, 3, 3)) * 0.03).astype(np.float32)
    g = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wk = _walk((b, h, w), off, r, th)
    if r is not None and math.ceil(r) <= dcn.RF_MAX:
        assert wk["inside"].all()
    else:
        assert not wk["inside"].all()
    ds = np.einsum("bhwo,oqit->bhwqti", g, wgt.reshape(c, 8, cpg, 9))
    dv = ds * mask.reshape(b, h, w, 8, 9)[..., None]
    contrib = dv[wk["src"] + (wk["group"], wk["tap"])] * wk["w"][:, None]
    dx = np.zeros((b, h, w, 8, cpg), np.float64)
    out = ~wk["inside"]
    np.add.at(dx, (wk["b"][out], wk["cy"][out], wk["cx"][out],
                   wk["group"][out]), contrib[out])
    rf = dcn.footprint_radius(r)
    tiles_x = -(-w // dcn.BWD_TW)
    for tile in np.unique(wk["tile"]):
        tb, rest = divmod(int(tile), -(-h // th) * tiles_x)
        y0, x0, fh, fw = dcn.footprint(rest // tiles_x * th,
                                       rest % tiles_x * dcn.BWD_TW, rf, th)
        sel = wk["inside"] & (wk["tile"] == tile)
        fp = np.zeros((fh, fw, 8, cpg))
        np.add.at(fp, (wk["cy"][sel] - y0, wk["cx"][sel] - x0,
                       wk["group"][sel]), contrib[sel])
        ys, xs = np.nonzero(np.abs(fp).sum((2, 3)))
        np.add.at(dx, (tb, ys + y0, xs + x0), fp[ys, xs])
    ref = dcn.dcn_bwd_plain(
        *(torch.from_numpy(a) for a in (x, off, mask, wgt, g)), 8, r)[0]
    _close(dx.reshape(b, h, w, c), ref.numpy(), "dx")
