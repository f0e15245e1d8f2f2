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
  block, with the sizes of ``dcn_fwd.cu``'s ``Shape`` and ``Fwd128`` and
  ``dcn_bwd.cu``'s ``Layout`` and ``Bwd128`` worked out by hand; the
  128-channel forward's constants read from its source, its sampling
  lanes (every (pixel, channel) of a tile once a tap, whole 16-byte units
  of one group) and its walk over 132 SMs; the 128-channel backward's
  walk (runs of (group, tile) items, each once, tiles of 6 rows in bf16
  and 4 in f32, every SM busy and every (group, pixel) of the image
  visited once) and its dx, summed per tile's 16-channel footprint plus
  the global path, against the plain dx.

Tolerances: 1e-5 x the largest magnitude of each result (f32 sums in other
orders), as the port's other DCN parity tests.
"""
import math
import re
from pathlib import Path

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


@pytest.mark.parametrize("cin,cout,dg", [
    (16, 16, 4), (64, 64, 4), (64, 32, 8), (32, 64, 8), (96, 96, 4),
    (256, 256, 8), (128, 64, 8), (400, 24, 8), (6, 10, 3), (256, 256, 1),
    (200, 8, 1)])
def test_narrow_plans_cover_each_channel_once_and_fit(cin, cout, dg):
    """The generalised kernels' K layout and layouts (``narrow_plan``,
    ``narrow_fwd_layout``, ``narrow_bwd_layout``, copies of ``make_plan``,
    ``fwd_layout``, ``bwd_layout``): each tap's K takes every input channel
    in exactly one slot, the padding (to whole 32-byte chunks of each step)
    holding none; each step whole groups or a piece of one group, read in
    whole CH-channel loads of at most 16 bytes, a group's pieces in
    consecutive steps of one slice; the forward's N and the backward's g
    chunks powers of two from 8 to 256 (the wgmma widths) covering cout
    once; both kernels within shared memory, in both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        es = dcn._es(dtype)
        q = dcn.narrow_plan(cin, cout, dg, dtype)
        cpg, e = cin // dg, q["E"]
        assert e * es == 32 and q["ch"] * es <= 16 and cpg % q["ch"] == 0
        chans = [dcn.narrow_channel_at(q, k) for k in range(q["kt"])]
        assert sorted(c for c in chans if c >= 0) == list(range(cin))
        assert q["kt"] % e == 0 and chans.count(-1) == q["kt"] - cin
        assert q["padded"] == (q["kt"] != cin)
        for j in range(q["nr"]):
            c0, c1, koff = dcn.narrow_range(q, j)
            assert koff % e == 0 and c0 % q["ch"] == 0
            assert chans[koff:koff + c1 - c0] == list(range(c0, c1))
            assert all(c < 0 for c in chans[koff + c1 - c0:
                                             koff + -(-(c1 - c0) // e) * e])
            if q["piece"]:
                assert c1 - c0 <= dcn.NARROW_STEP_CH
                assert c0 // cpg == (c1 - 1) // cpg
            else:
                assert c0 % cpg == 0 and c1 % cpg == 0
                assert c1 - c0 <= max(cpg, dcn.NARROW_STEP_CH)
        f = dcn.narrow_fwd_layout(cin, cout, dg, dtype)
        assert f["N"] in dcn.NARROW_NW and f["N"] >= min(cout, 256)
        assert f["nb"] * f["N"] >= cout > (f["nb"] - 1) * f["N"]
        assert f["rows"] == 64 * f["nwg"] and f["smem"] <= 232448
        bl = dcn.narrow_bwd_layout(cin, cout, dg, dtype)
        cols = [gc * bl["gch"] + i for gc in range(bl["ngc"])
                for i in range(bl["gch"])]
        assert sorted(c for c in cols if c < cout) == list(range(cout))
        assert bl["nw0"] in dcn.NARROW_NW and bl["nwl"] in dcn.NARROW_NW
        assert bl["nw0"] >= bl["gch"] and bl["nwl"] * (bl["ngc"] > 1) <= \
            bl["nw0"]
        assert bl["smem"] <= 232448
        if q["piece"]:   # a slice never splits a group's pieces
            assert bl["sps"] % q["ppg"] == 0
        assert dcn.bwd_smem_bytes(dtype, 8, cin, dg, cout, False) == \
            bl["smem"]


SAMPLED = [(16, 16, 4), (24, 40, 4), (64, 64, 8), (256, 256, 8),
           (512, 64, 1), (6, 10, 3)]


@pytest.mark.parametrize("cin,cout,dg", SAMPLED,
                         ids=[f"{a}to{b}_dg{g}" for a, b, g in SAMPLED])
def test_narrow_sampling_covers_each_channel_once(cin, cout, dg):
    """The narrow forward's sampling of one tile into its A stages
    (``narrow_items``, the kernel's walk; ``narrow_sw32_at``, desc_sw32's
    layout), super-step by super-step, and the backward's S^T of each step:
    every element of a stage's K range written exactly once (the samples,
    then the padding's zeros), each CH-channel store within one 16-byte
    unit, the unit of row r's 16-byte slot u at u ^ ((r >> 2) & 1); the
    lanes of a pixel on consecutive threads reading neighbouring channels
    (at 64 channels in 8 groups, 8 lanes a 128-byte row); and every (row,
    pixel) of a K-block's S^T that holds a channel written once."""
    for dtype in (torch.bfloat16, torch.float32):
        es = dcn._es(dtype)
        q = dcn.narrow_plan(cin, cout, dg, dtype)
        lay = dcn.narrow_fwd_layout(cin, cout, dg, dtype)
        rows, e = lay["rows"], q["E"]
        nsteps = 9 * q["nr"]
        for ss in range(lay["nsuper"]):
            f0 = ss * lay["qs"]
            f1 = min(f0 + lay["qs"], nsteps)
            kbase = dcn.narrow_k_of(q, f0)
            nk = dcn.narrow_k_of(q, f1) - kbase
            assert 0 < nk <= lay["sc"] * e and nk % e == 0
            seen = np.zeros(lay["sc"] * rows * 32, np.int64)
            items = dcn.narrow_items(q, rows, 2 * rows, f0, f1 - f0)
            for t, its in enumerate(items):
                for r, f, grp, lo, hi in its:
                    c0, _, koff = dcn.narrow_range(q, f % q["nr"])
                    k0 = f // q["nr"] * q["kt"] + koff - kbase - c0
                    for ch in range(lo, hi, q["ch"]):
                        at = [dcn.narrow_sw32_at(r, k0 + c, rows, es)
                              for c in range(ch, ch + q["ch"])]
                        assert len({a // 16 for a in at}) == 1
                        for a in at:
                            seen[a:a + es] += 1
            # the padding's zeros, as the kernel's second pass writes
            for f in range(f0, f1):
                c0, c1, koff = dcn.narrow_range(q, f % q["nr"])
                w = c1 - c0
                for k in range(w, -(-w // e) * e):
                    for r in range(rows):
                        a = dcn.narrow_sw32_at(
                            r, f // q["nr"] * q["kt"] + koff - kbase + k,
                            rows, es)
                        seen[a:a + es] += 1
            assert (seen[:nk * rows * es] == 1).all()
            assert (seen[nk * rows * es:] == 0).all()
        # the swizzle: slot u of row r holds unit u ^ ((r >> 2) & 1)
        for r in range(8):
            for k in range(0, e, 16 // es):
                a = dcn.narrow_sw32_at(r, k, rows, es)
                assert a // 16 % 2 == (k * es // 16) ^ ((r >> 2) & 1)
        # the backward's S^T of each K-block (qb steps, step i at rows
        # i * wfull): (row, pixel) once for each step's channels
        blay = dcn.narrow_bwd_layout(cin, cout, dg, dtype)
        assert blay["qb"] * q["wfull"] <= 64
        for kb in range(min(blay["nkb"], 3)):
            f0 = kb * blay["qb"]
            nf = min(blay["qb"], nsteps - f0)
            st = np.zeros((64, 64), np.int64)
            for its in dcn.narrow_items(q, 64, 128, f0, nf):
                for r, f, _, lo, hi in its:
                    c0 = dcn.narrow_range(q, f % q["nr"])[0]
                    row = (f - f0) * q["wfull"] - c0
                    st[row + lo:row + hi, r] += 1
            want = np.zeros((64, 64), np.int64)
            for i in range(nf):
                c0, c1, _ = dcn.narrow_range(q, (f0 + i) % q["nr"])
                want[i * q["wfull"]:i * q["wfull"] + c1 - c0] = 1
            assert (st == want).all()
    if (cin, dg) != (64, 8):
        return
    # 64 channels in 8 groups: threads 8 i ... 8 i + 7 take one pixel's 8
    # groups, a full 128-byte row of bf16 a corner
    q = dcn.narrow_plan(64, 64, 8, torch.bfloat16)
    items = dcn.narrow_items(q, 128, 256, 0, 1)
    for i in range(0, 32, 8):
        firsts = [items[t][0] for t in range(i, i + 8)]
        assert len({r for r, *_ in firsts}) == 1
        assert sorted(lo for *_, lo, _ in firsts) == list(range(0, 64, 8))


# ---------------------------------------------------------------- (c)


def test_shared_memory_of_every_width_fits_a_block():
    """Worked out from the sources' layouts: the 128-channel forward
    (``Fwd128``) holds a ring of 4 A stages (one 128-byte chunk of the 8 x
    16 tile's pixels each), 3 weight slots (one chunk of a tap for the 128
    outputs each), 4 MMA warps' epilogue rows (16 pixels x (128 + 16) B)
    and 11 mbarriers, in either dtype; the backward (``Bwd128``) its g tile
    (chunks x TH x 32 pixels x 128 B), a ring of three weight taps (chunks
    x 16 rows x 128 B), two S slots of 16 x (pixels + pad), two dS slots of
    pixels x 16 in the input dtype, two f32 a sampling warp, 10 mbarriers
    (rounded up to 16 bytes) and the footprint of 17 ints a pixel."""
    bf, f32 = torch.bfloat16, torch.float32
    assert (dcn.tile_rows(bf, 128), dcn.tile_rows(f32, 128)) == (8, 8)
    assert dcn.tile_rows(bf, 128, bwd=True) == 6
    assert dcn.tile_rows(f32, 128, bwd=True) == 4
    for dt in (bf, f32):
        assert dcn.fwd_smem_bytes(dt, 128, 8) == (
            4 * 128 * 128 + 3 * 128 * 128 + 4 * 16 * 144 + 11 * 8)  # 121 KB
        # one block an SM, with L1 above 100 KB for the gathers
        assert dcn.fwd_smem_bytes(dt, 128, 8) <= 132 * 1024 - 1024
    fp6 = (6 + 19) * (32 + 19) * 17 * 4
    fp4 = (4 + 19) * (32 + 19) * 17 * 4
    assert dcn.bwd_smem_bytes(bf, 8, 128, 8) == (
        2 * 192 * 128 + 3 * 2 * 16 * 128 + 2 * 16 * 200 * 2
        + 2 * 192 * 16 * 2 + 12 * 8 + 10 * 8 + fp6)             # 173404
    assert dcn.bwd_smem_bytes(f32, 8, 128, 8) == (
        64 * 1024 + 3 * 4 * 16 * 128 + 2 * 16 * 132 * 4 + 2 * 128 * 16 * 4
        + 8 * 8 + 10 * 8 + fp4)                                 # 203300
    # the 64-wide ones as they were
    assert dcn.fwd_smem_bytes(bf) == 9 * 64 * 128 + 2 * 256 * 128
    assert dcn.fwd_smem_bytes(f32) == 9 * 2 * 64 * 128 + 2 * 2 * 128 * 128
    for dtype in (bf, f32):
        for c, dg in WIDTHS + [(64, 8), (16, 4), (64, 1), (24, 3)]:
            assert dcn.fwd_smem_bytes(dtype, c, dg) <= 232448, (c, dg)
            for r in (None, 0.5, 4, 8, 12):
                assert dcn.bwd_smem_bytes(
                    dtype, dcn.footprint_radius(r), c, dg) <= 232448
    # the narrow kernels: every shape of the widened domain fits a block,
    # in both forms, the debug width's two kernels two blocks an SM
    for dtype in (bf, f32):
        for cin, cout, dg in ((64, 32, 8), (32, 64, 8), (96, 96, 4),
                              (256, 256, 8), (128, 64, 8), (400, 24, 8),
                              (16, 300, 4), (512, 16, 1), (64, 64, 8)):
            for m in (True, False):
                assert dcn.fwd_smem_bytes(dtype, cin, dg, cout, m) <= 232448
                assert dcn.bwd_smem_bytes(dtype, 8, cin, dg, cout, m) <= \
                    232448
        assert dcn.narrow_blocks_per_sm(16, 16, 4, dtype) >= 2
        assert 2 * (dcn.narrow_fwd_layout(16, 16, 4, dtype)["smem"]
                    + 1024) <= 228 * 1024
    # 256 -> 256 in 8 groups: a column block of 256 (the forward's N) over
    # 2 warpgroups, the weight streamed; the backward holds one step's dW
    # (256 x 64 f32) in shared memory and stages g once a tile
    f = dcn.narrow_fwd_layout(256, 256, 8, bf)
    assert (f["N"], f["nb"], f["nwg"], f["resident"]) == (256, 1, 2, 0)
    b = dcn.narrow_bwd_layout(256, 256, 8, bf)
    assert (b["ngc"], b["nw0"], b["sps"], b["dws"]) == (1, 256, 1, 1)
    # the debug width: one super-step's stage of 4 warpgroups, the weight
    # resident, the whole dW of the backward in one slice
    f = dcn.narrow_fwd_layout(16, 16, 4, bf)
    assert (f["N"], f["nwg"], f["resident"]) == (16, 4, 1)
    b = dcn.narrow_bwd_layout(16, 16, 4, bf)
    assert (b["nslices"], b["resident"], b["dws"]) == (1, 1, 1)


def test_bwd_128_constants_are_the_kernel_source():
    """``dcn.py``'s mirror of the 128-channel backward (tile rows, weight
    ring) reads as ``dcn_bwd.cu``'s ``Bwd128`` states it."""
    src = (Path(dcn.__file__).resolve().parents[2] / "csrc"
           / "dcn_bwd.cu").read_text()
    body = src[src.index("struct Bwd128 {"):src.index("};", src.index(
        "struct Bwd128 {"))]
    rows = re.search(r"int TH = kF32 \? (\d+) : (\d+);", body)
    assert (int(rows[1]), int(rows[2])) == (
        dcn.BWD128_ROWS[torch.float32], dcn.BWD128_ROWS[torch.bfloat16])
    assert int(re.search(r"int kWs = (\d+);", body)[1]) == dcn.BWD128_WS
    assert f"int kTW = {dcn.BWD_TW};" in src
    assert f"int kRfMax = {dcn.RF_MAX};" in src


def test_fwd_128_constants_are_the_kernel_source():
    """``dcn.py``'s mirror of the 128-channel forward (tile rows, A stages,
    weight slots, the tile width) reads as ``dcn_fwd.cu``'s ``Fwd128``
    states it, and its registers split as the launch allows."""
    src = (Path(dcn.__file__).resolve().parents[2] / "csrc"
           / "dcn_fwd.cu").read_text()
    body = src[src.index("struct Fwd128 {"):src.index("};", src.index(
        "struct Fwd128 {"))]
    assert int(re.search(r"int TH = (\d+);", body)[1]) == dcn.FWD128_ROWS
    assert int(re.search(r"int kSampWarps = (\d+);", body)[1]) == \
        dcn.FWD128_WARPS
    assert int(re.search(r"int kStages = (\d+);", body)[1]) == \
        dcn.FWD128_STAGES
    assert int(re.search(r"int kWs = (\d+);", body)[1]) == dcn.FWD128_WS
    assert f"int kTW = {dcn.FWD_TW};" in src
    regs = re.search(r"int kSampRegs = (\d+), kMmaRegs = (\d+);", body)
    samp, mma = int(regs[1]), int(regs[2])
    threads = dcn.FWD128_WARPS * 32 + 128
    assert samp % 8 == mma % 8 == 0 and mma >= 128 + 32
    assert dcn.FWD128_WARPS * 32 * samp + 128 * mma <= \
        65536 // threads // 8 * 8 * threads


def test_fwd_128_sampling_covers_each_channel_once():
    """Over the steps of one tap (a 128-byte chunk each: 2 bf16, 4 f32),
    the 16 sampling warps' lanes write every (pixel, channel) of the 8 x
    16 tile's A stage exactly once, in whole 16-byte units of one
    deformable group (16 channels), each warp within one tile row; a
    quarter warp writes one pixel's full 128-byte chunk row (the kernel's
    conflict-free stores and whole-line gathers), and lanes l and l ^ 1
    sample the same (pixel, group) (the kernel's shared corners)."""
    for dtype in (torch.bfloat16, torch.float32):
        es = dcn._es(dtype)
        chunks, v = 128 * es // 128, 16 // es
        seen = np.zeros((128, 128), np.int64)
        for c in range(chunks):
            for warp in range(dcn.FWD128_WARPS):
                for lane in range(32):
                    items = dcn.fwd128_items(dtype, c, warp, lane)
                    assert len(items) == 2
                    assert len({r // dcn.FWD_TW for r, *_ in items}) == 1
                    for row, unit, ch0, g in items:
                        assert ch0 == c * 128 // es + unit * v
                        assert ch0 // 16 == (ch0 + v - 1) // 16 == g
                        seen[row, ch0:ch0 + v] += 1
                    pair = dcn.fwd128_items(dtype, c, warp, lane ^ 1)
                    assert [(r, g) for r, _, _, g in items] == \
                        [(r, g) for r, _, _, g in pair]
                for q in range(4):   # a quarter warp: 8 units of one pixel
                    items = [dcn.fwd128_items(dtype, c, warp, lane)[0]
                             for lane in range(8 * q, 8 * q + 8)]
                    assert len({r for r, *_ in items}) == 1
                    assert sorted(u for _, u, *_ in items) == list(range(8))
        assert (seen == 1).all()


@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (7, 37, 70)],
                         ids=["even", "ragged"])
def test_fwd_128_walk_visits_each_pixel_once(b, h, w):
    """The 128-channel forward's persistent walk over 132 SMs: 8 x 16
    tiles in either dtype, blocks whose tile counts differ by at most one,
    and every pixel of the image in exactly one tile of one block."""
    for dtype in (torch.bfloat16, torch.float32):
        th = dcn.tile_rows(dtype, 128)
        tiles_y, tiles_x = -(-h // th), -(-w // dcn.FWD_TW)
        grid = dcn.fwd128_grid(b, h, w, 132)
        assert len(grid) == min(132, b * tiles_y * tiles_x)
        sizes = [len(t) for t in grid]
        assert max(sizes) - min(sizes) <= 1
        seen = np.zeros((b, tiles_y * th, tiles_x * dcn.FWD_TW), np.int64)
        for tiles in grid:
            for tile in tiles:
                tb, rest = divmod(tile, tiles_y * tiles_x)
                ty, tx = divmod(rest, tiles_x)
                seen[tb, ty * th:(ty + 1) * th,
                     tx * dcn.FWD_TW:(tx + 1) * dcn.FWD_TW] += 1
        assert (seen[:, :h, :w] == 1).all()


@pytest.mark.parametrize("hw", [(13, 45), (16, 64)], ids=["ragged", "even"])
def test_bwd_128_walk_visits_each_group_tile_once(hw):
    """Each block takes a run of (group, tile) items, item j = group *
    ntiles + tile in order, runs of equal length to one item, each spanning
    at most two groups (the block's dW stays in registers between group
    changes); every (group, tile) once."""
    h, w = hw
    for dtype in (torch.bfloat16, torch.float32):
        th = dcn.tile_rows(dtype, 128, bwd=True)
        ntiles = 2 * -(-h // th) * -(-w // dcn.BWD_TW)
        grid = dcn.bwd_grid(2, h, w, 132, dtype, 128, 8)
        assert len(grid) == min(8 * ntiles, 132)
        pairs = [it for g, items in grid for it in items]
        assert all(g is None for g, _ in grid)
        assert len(pairs) == len(set(pairs)) == 8 * ntiles
        assert pairs == [divmod(j, ntiles) for j in range(8 * ntiles)]
        sizes = {len(items) for _, items in grid}
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
        assert all(len({g for g, _ in items}) <= 2 for _, items in grid)


@pytest.mark.parametrize("b,h,w", [(2, 64, 96), (3, 37, 70)],
                         ids=["even", "ragged"])
def test_bwd_128_walk_fills_every_sm(b, h, w):
    """With at least 132 (group, tile) items the grid is 132 blocks, one
    an SM, whose work differs by at most one item, and the items' tiles
    cover every (group, pixel) of the image exactly once."""
    for dtype in (torch.bfloat16, torch.float32):
        th = dcn.tile_rows(dtype, 128, bwd=True)
        tiles_y, tiles_x = -(-h // th), -(-w // dcn.BWD_TW)
        grid = dcn.bwd_grid(b, h, w, 132, dtype, 128, 8)
        assert 8 * b * tiles_y * tiles_x >= 132 and len(grid) == 132
        sizes = [len(items) for _, items in grid]
        assert max(sizes) - min(sizes) <= 1
        seen = np.zeros((8, b, tiles_y * th, tiles_x * dcn.BWD_TW), np.int64)
        for _, items in grid:
            for g, tile in items:
                tb, rest = divmod(tile, tiles_y * tiles_x)
                ty, tx = divmod(rest, tiles_x)
                seen[g, tb, ty * th:(ty + 1) * th,
                     tx * dcn.BWD_TW:(tx + 1) * dcn.BWD_TW] += 1
        assert (seen[:, :, :h, :w] == 1).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("r,std", [(8, 4.0), (4.5, 3.0), (None, 12.0)],
                         ids=["r8", "r4.5", "exact_far"])
def test_bwd_128_footprint_routes_and_sums_dx(r, std, dtype):
    """At 128 channels (16 a group) and the kernel's tiles (6 rows in
    bf16, 4 in f32):
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
