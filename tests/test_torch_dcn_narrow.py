"""The DCN kernels' narrow design (``csrc/dcn_narrow.cu``) at 16 channels in
4 deformable groups, the width of the repo's debug configs, on the CPU (its
other widths: ``test_torch_dcn_widths.py``).

The kernels run only on the card (``tests/test_torch_cuda.py``); here,
from numpy seeds in f32, at ±4, ±8 and exact:

* (a) the plain forward and backward at this width (what the card's checks
  hold the kernels to), separate and in-place ``om`` forms, against the JAX
  package's exact DCN and ``jax.vjp`` of it;
* (b) a numpy mirror of the kernels' arithmetic on their layouts: the
  forward as S W over the K layout (S made from the masked samples in
  32-byte chunks of each tap's steps, the weight read back from the
  packed image of ``narrow_pack_fwd``), the backward's dS = g W^T from
  ``narrow_pack_bwd``'s image rounded to T, the corner products E_k, mask
  and position gradients with the clamp's gates, dx as the scatter of dS *
  mask * (corner weight), and dW as g^T S summed per block over the
  persistent walk, against the plain versions;
* (c) the backward's walk (``bwd_grid``): every (slice, tile) item taken by
  one block, each pixel in one tile, each block's slices in one run; and
  the kernels' constants read from ``dcn_narrow.cu``'s source.

Tolerances: 1e-5 x the largest magnitude of each result (f32 sums in other
orders), as the port's other DCN parity tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu_torch.ops.deform_conv import split_om
from realvsr_tpu_torch.ops.kernels import dcn
from realvsr_tpu_torch.ops.kernels.conv3x3 import round_tf32

REL = 1e-5
C, DG = dcn.NARROW
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


def _inputs(seed, shape=(2, 9, 13)):
    rng = np.random.default_rng(seed)
    b, h, w = shape
    x = rng.normal(size=(b, h, w, C)).astype(np.float32)
    # offsets of std 3 px: taps leave the image, some beyond ±8
    om = np.concatenate([rng.normal(size=(b, h, w, 18 * DG)) * 3,
                         rng.normal(size=(b, h, w, 9 * DG))], -1
                        ).astype(np.float32)
    wgt = (rng.normal(size=(C, C, 3, 3)) * 0.2).astype(np.float32)
    bias = (rng.normal(size=C) * 0.1).astype(np.float32)
    g = rng.normal(size=(b, h, w, C)).astype(np.float32)
    return x, om, wgt, bias, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ---------------------------------------------------------------- (a)


@pytest.mark.parametrize("r", RADII, ids=["r4", "r8", "exact"])
def test_narrow_plain_matches_jax(r):
    x, om, wgt, bias, g = _inputs(0 if r is None else r)
    xt, omt, wt, bt, gt = _t(x, om, wgt, bias, g)
    off, mask = split_om(omt, DG)
    joff = jnp.asarray(off.numpy())
    if r is not None:
        joff = jnp.clip(joff, -r, r)
    jw = jnp.asarray(wgt.transpose(2, 3, 1, 0))

    def f(x_, off_, mask_, w_):
        return jdc.modulated_deform_conv(x_, off_, mask_, w_, None, 1, 1, 1,
                                         1, DG, impl="columns")

    ref, vjp = jax.vjp(f, jnp.asarray(x), joff, jnp.asarray(mask.numpy()),
                      jw)
    out = dcn.dcn_fwd(xt, off.contiguous(), mask.contiguous(), wt, None, DG,
                      None, r)
    _close(out, ref, "forward")
    _close(dcn.dcn_fwd_om(xt, omt, wt, bt, DG, "lrelu", r),
           dcn.dcn_fwd(xt, off.contiguous(), mask.contiguous(), wt, bt, DG,
                       "lrelu", r), "om forward")
    dref = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    dx, doff, dmask, dw = dcn.dcn_bwd(xt, off.contiguous(),
                                      mask.contiguous(), wt, gt, DG, r)
    _close(dx, dref[0], "dx")
    if r is not None:  # the clamp's gate: no gradient beyond ±R
        dref[1] = np.where(np.abs(off.numpy()) <= r, dref[1], 0)
    _close(doff, dref[1], "doffset")
    _close(dmask, dref[2], "dmask")
    _close(dw.permute(2, 3, 1, 0), dref[3], "dweight")
    dx2, dom, dw2 = dcn.dcn_bwd_om(xt, omt, wt, gt, DG, r)
    torch.testing.assert_close(dx2, dx, rtol=0, atol=0)
    torch.testing.assert_close(dw2, dw, rtol=0, atol=0)
    assert dom.shape == om.shape


# ---------------------------------------------------------------- (b)


def _geometry(off, b, h, w, r):
    """Per (b, y, x, group, tap): the clamped position's corners, weights,
    validity and the clamp's gates, as ``dcn_sample.cuh::corners``."""
    o = off.reshape(b, h, w, DG, 9, 2)
    gate = np.ones(o.shape, bool) if r is None else np.abs(o) <= r
    if r is not None:
        o = np.clip(o, -r, r)
    yi, xi = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    taps = np.arange(9)
    py = (yi[None, :, :, None, None] - 1 + taps // 3) + o[..., 0]
    px = (xi[None, :, :, None, None] - 1 + taps % 3) + o[..., 1]
    fy, fx = np.floor(py), np.floor(px)
    ty, tx = py - fy, px - fx
    cw = [(1 - ty) * (1 - tx), (1 - ty) * tx, ty * (1 - tx), ty * tx]
    cy = [fy, fy, fy + 1, fy + 1]
    cx = [fx, fx + 1, fx, fx + 1]
    valid = [(cy[k] >= 0) & (cy[k] <= h - 1) & (cx[k] >= 0)
             & (cx[k] <= w - 1) for k in range(4)]
    return ty, tx, cw, cy, cx, valid, gate


def _corners(x, b, cy, cx, valid):
    """x at each corner: (b, h, w, group, tap, 4 channels), 0 where invalid."""
    bi = np.arange(b)[:, None, None, None, None]
    yy = np.clip(cy, 0, x.shape[1] - 1).astype(np.int64)
    xx = np.clip(cx, 0, x.shape[2] - 1).astype(np.int64)
    gi = np.arange(DG)[None, None, None, :, None]
    v = x.reshape(*x.shape[:3], DG, C // DG)[bi, yy, xx, gi]
    return np.where(valid[..., None], v, 0)


def _k_index(q):
    """The K index of each (tap, channel) in the kernels' layout: tap * kt
    + the step's offset + the channel's place in the step."""
    kix = np.zeros((9, q["Ci"]), np.int64)
    for tap in range(9):
        for j in range(q["nr"]):
            c0, c1, koff = dcn.narrow_range(q, j)
            kix[tap, c0:c1] = tap * q["kt"] + koff + np.arange(c1 - c0)
    return kix


def _fwd_matrix(packed, q, lay, cout):
    """W[K, cout] read back from the forward's packed image (its swizzle
    undone)."""
    n, e, u = lay["N"], q["E"], q["E"] // 2
    chunks = 9 * q["kt"] // e
    img = packed.float().numpy().reshape(lay["nb"], chunks, n, e)
    w = np.zeros((9 * q["kt"], lay["nb"] * n), np.float32)
    for nn in range(n):
        sw = (nn >> 2) & 1
        for pos in range(e):
            lw = ((pos // u) ^ sw) * u + pos % u
            for cb in range(lay["nb"]):
                w[np.arange(chunks) * e + lw, cb * n + nn] = img[cb, :, nn,
                                                                 pos]
    return w[:, :cout]


def _bwd_matrix(packed, q, lay, cout):
    """Wt[K-block, cout, 64 channel rows] read back from the backward's
    packed image (its swizzle and the g chunks' padding undone)."""
    e, u = q["E"], q["E"] // 2
    chunks = lay["cow"] // e
    img = packed.float().numpy().reshape(lay["nkb"], chunks, 64, e)
    wt = np.zeros((lay["nkb"], lay["cow"], 64), np.float32)
    for nn in range(64):
        sw = (nn >> 2) & 1
        for pos in range(e):
            lw = ((pos // u) ^ sw) * u + pos % u
            wt[:, np.arange(chunks) * e + lw, nn] = img[:, :, nn, pos]
    cols = [gc * lay["gch"] + i for gc in range(lay["ngc"])
            for i in range(lay["nw0"] if gc < lay["ngc"] - 1 else lay["nwl"])]
    keep = [i for i, c in enumerate(cols) if c < cout and
            i - (i // lay["nw0"]) * lay["nw0"] < lay["gch"]]
    return wt[:, keep, :]


@pytest.mark.parametrize("r", RADII, ids=["r4", "r8", "exact"])
def test_numpy_mirror_of_the_narrow_kernels(r):
    """The kernels' own formulas on their own layouts, in numpy: the
    forward as S W with S the masked samples placed at each (tap,
    channel)'s K index (32-byte chunks of each tap's steps, zero padding)
    and W read back from ``narrow_pack_fwd``'s image; the backward's dS =
    g W^T from ``narrow_pack_bwd``'s image, rounded to T (f32 here), E_k =
    dS . corner k, dmask = sum_k w_k E_k, the position gradients as m times
    differences of the E_k behind the clamp's gates, dx as the scatter of
    dS * m * w_k to each valid corner, and dW as g^T S per (slice, tile)
    item, summed in each block's partials over the persistent walk and then
    over the blocks.  The weight is one TF32 holds (the images' f32 values
    are TF32, as the tensor cores take them), S the f32 samples."""
    x, om, wgt, bias, g = _inputs(10 + (0 if r is None else r))
    # a weight TF32 holds exactly: the packed f32 images round to TF32 as
    # the tensor cores take them, and the point here is their layout
    wgt = round_tf32(torch.from_numpy(wgt)).numpy()
    b, h, w = x.shape[:3]
    f32 = torch.float32
    q = dcn.narrow_plan(C, C, DG, f32)
    flay, blay = (dcn.narrow_fwd_layout(C, C, DG, f32),
                  dcn.narrow_bwd_layout(C, C, DG, f32))
    off = om[..., :18 * DG]
    m = 1 / (1 + np.exp(-om[..., 18 * DG:].reshape(b, h, w, DG, 9)))
    ty, tx, cw, cy, cx, valid, gate = _geometry(off, b, h, w, r)
    e = [_corners(x, b, cy[k], cx[k], valid[k]) for k in range(4)]
    val = sum(e[k] * cw[k][..., None] for k in range(4))
    s = val * m[..., None]                          # (b,h,w,g,tap,4)
    # S[P, K]: each (tap, channel) at its K index, the padding zero
    kix = _k_index(q)
    smat = np.zeros((b * h * w, 9 * q["kt"]), np.float32)
    st = s.transpose(0, 1, 2, 4, 3, 5).reshape(b * h * w, 9, C)
    for tap in range(9):
        smat[:, kix[tap]] = st[:, tap]
    wmat = _fwd_matrix(dcn.narrow_pack_fwd(torch.from_numpy(wgt), DG), q,
                       flay, C)
    out = (smat @ wmat).reshape(b, h, w, C) + bias
    xt, omt, wt, bt, gt = _t(x, om, wgt, bias, g)
    _close(out, dcn.dcn_fwd_om(xt, omt, wt, bt, DG, None, r), "forward")

    # dS[P, K-block, row] = g Wt, then (tap, channel) order, rounded to T:
    # row n of K-block kb is channel n % wfull of step kb * qb + n // wfull
    wtm = _bwd_matrix(dcn.narrow_pack_bwd(torch.from_numpy(wgt), DG), q,
                      blay, C)
    gp = g.reshape(b * h * w, C)
    ds_blocks = np.einsum("po,kon->pkn", gp, wtm)
    dsc = np.zeros((b * h * w, 9, C), np.float32)
    for f in range(9 * q["nr"]):
        tap, j = divmod(f, q["nr"])
        c0, c1, _ = dcn.narrow_range(q, j)
        kb, sub = divmod(f, blay["qb"])
        row = sub * q["wfull"]
        dsc[:, tap, c0:c1] = ds_blocks[:, kb, row:row + c1 - c0]
    dsc = torch.from_numpy(dsc).to(f32).float().numpy()
    ds = dsc.reshape(b, h, w, 9, DG, C // DG).transpose(0, 1, 2, 4, 3, 5)
    wk = wgt.reshape(C, DG, C // DG, 9)             # (co, g, i, tap)
    _close(ds, np.einsum("bhwo,ogit->bhwgti", g, wk), "dS from the image")
    E = [(ds * e[k]).sum(-1) for k in range(4)]
    dm = sum(cw[k] * E[k] for k in range(4))
    dty = m * ((1 - tx) * (E[2] - E[0]) + tx * (E[3] - E[1]))
    dtx = m * ((1 - ty) * (E[1] - E[0]) + ty * (E[3] - E[2]))
    doff = np.stack([dty, dtx], -1) * gate
    dx = np.zeros((b, h, w, DG, C // DG))
    bi = np.broadcast_to(np.arange(b)[:, None, None, None, None], dm.shape)
    gi = np.broadcast_to(np.arange(DG)[:, None], dm.shape)
    for k in range(4):
        sel = valid[k]
        np.add.at(dx, (bi[sel], cy[k][sel].astype(np.int64),
                       cx[k][sel].astype(np.int64), gi[sel]),
                  (ds * (m * cw[k])[..., None])[sel])
    # dW: g^T S per item, in each block's partials, then over the blocks
    grid = dcn.bwd_grid(b, h, w, 132, f32, C, DG)
    dw = np.zeros((C, 9, C))
    for _, items in grid:
        part = np.zeros((C, 9, C))
        for sl, tile in items:
            pix = np.array(dcn.narrow_tile_pixels(tile, h, w, 64))
            rows = pix >= 0
            kbs = range(sl * blay["sps"],
                        min(sl * blay["sps"] + blay["sps"], blay["nkb"]))
            for f in [kb * blay["qb"] + i for kb in kbs
                      for i in range(blay["qb"])
                      if kb * blay["qb"] + i < 9 * q["nr"]]:
                tap, j = divmod(f, q["nr"])
                c0, c1, _ = dcn.narrow_range(q, j)
                part[:, tap, c0:c1] += gp[pix[rows]].T @ st[pix[rows], tap,
                                                          c0:c1]
        dw += part
    pdx, pdoff, pdmask, pdw = dcn.dcn_bwd_plain(
        xt, *split_om(omt, DG), wt, gt, DG, r)
    _close(dx.reshape(b, h, w, C), pdx, "dx")
    _close(doff.reshape(b, h, w, 18 * DG), pdoff, "doffset")
    _close(dm.reshape(b, h, w, 9 * DG), pdmask, "dmask")
    _close(dw.transpose(0, 2, 1), pdw.reshape(C, C, 9), "dweight")


# ---------------------------------------------------------------- (c)


@pytest.mark.parametrize("shape", [(12, 64, 64), (2, 13, 45), (1, 5, 7)],
                         ids=["debug_L1", "ragged", "tiny"])
def test_narrow_bwd_walk_takes_each_run_once(shape):
    """The backward's persistent walk (``bwd_grid``) at 16 in 4 groups:
    every (slice, tile) item in exactly one block, each block's items one
    run with each slice in one stretch of it (its dW partials go out once a
    slice), the tiles' pixels every pixel of the image once, and the grid
    no larger than the blocks that fit the SMs; both kernels within
    shared memory, the backward's 9 steps three K-blocks of 64 channel rows
    (4 + 4 + 1 steps of 16) and those one slice (the whole dW of this width
    held by each block)."""
    b, h, w = shape
    for dtype in (torch.bfloat16, torch.float32):
        lay = dcn.narrow_bwd_layout(C, C, DG, dtype)
        q = dcn.narrow_plan(C, C, DG, dtype)
        tiles_x, tiles_y, th, tw = dcn.narrow_tiles(h, w, dcn.NARROW_ROWS)
        assert th * tw == dcn.NARROW_ROWS
        ntiles = b * tiles_x * tiles_y
        grid = dcn.bwd_grid(b, h, w, 132, dtype, C, DG)
        assert all(grp is None for grp, _ in grid)  # every group a block
        items = [it for _, its in grid for it in its]
        assert sorted(items) == [divmod(i, ntiles) for i in range(
            lay["nslices"] * ntiles)]
        assert len(grid) <= dcn.narrow_blocks_per_sm(C, C, DG, dtype) * 132
        for _, its in grid:
            runs = [s for i, (s, _) in enumerate(its)
                    if i == 0 or its[i - 1][0] != s]
            assert len(runs) == len(set(runs))
        covered = np.concatenate([dcn.narrow_tile_pixels(t, h, w,
                                                         dcn.NARROW_ROWS)
                                  for t in range(ntiles)])
        assert (np.sort(covered[covered >= 0]) == np.arange(b * h * w)).all()
        assert lay["nslices"] == 1 and lay["dws"] and lay["sps"] == 3
        assert lay["qb"] * q["wfull"] == 64 and lay["nkb"] == 3
        # shared memory for two blocks an SM at least, either kernel
        for smem in (dcn.bwd_smem_bytes(dtype, 8, C, DG),
                     dcn.fwd_smem_bytes(dtype, C, DG)):
            assert 2 * (smem + 1024) <= 228 * 1024
    # the 64-wide walk is unchanged by the extra arguments' defaults
    assert dcn.bwd_grid(b, h, w, 132, torch.bfloat16) == dcn.bwd_grid(
        b, h, w, 132, torch.bfloat16, dcn.C, dcn.GROUPS)


def test_narrow_constants_are_the_kernel_source():
    """``dcn.py``'s copies of ``dcn_narrow.cu``'s constants (a backward
    block's threads, a tile's rows, a step's channels, the one-stage and
    super-step chunks, the column block, the budgets, the epilogue row),
    its wgmma widths, its forward blocks' warpgroups, the dS row, the
    backward's tries of slots and slices, and its shared-memory sums, read
    from the source."""
    import re

    from realvsr_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "dcn_narrow.cu").read_text()
    const = {k: eval(v) for k, v in
             re.findall(r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert const["kThreads"] == dcn.NARROW_THREADS
    assert const["kRows"] == dcn.NARROW_ROWS
    assert const["kStepCh"] == dcn.NARROW_STEP_CH
    assert const["kOneStage"] == dcn.NARROW_ONE_STAGE
    assert const["kStageChunks"] == dcn.NARROW_STAGE_CHUNKS
    assert const["kColBlock"] == dcn.NARROW_COL_BLOCK
    assert const["kFwdResident"] == dcn.NARROW_FWD_RESIDENT
    assert const["kSlotBytes"] == dcn.NARROW_SLOT_BYTES
    assert const["kStageBytes"] == dcn.NARROW_STAGE_BYTES
    assert const["kBwdResident"] == dcn.NARROW_BWD_RESIDENT
    assert const["kDwBudget"] == dcn.NARROW_DW_BUDGET
    assert const["kEpiLd"] == dcn.NARROW_EPI_LD
    assert const["kSmemMax"] == 232448
    # the wgmma N of nw_of, and the forward's warpgroups a block
    body = re.search(r"inline int nw_of\(int w\) \{(.*?)\n\}", src, re.S)[1]
    assert "int n = 8;" in body and "n *= 2;" in body
    assert dcn.NARROW_NW == tuple(8 << i for i in range(6))
    wg = re.search(r"fwd_max_wg\(int N, int es\) \{\s*return N <= \(es == 2 "
                   r"\? (\d+) : (\d+)\) \? (\d+) : (\d+);", src)
    for n in dcn.NARROW_NW:
        for dtype, lim in ((torch.bfloat16, wg[1]), (torch.float32, wg[2])):
            assert dcn.narrow_fwd_max_wg(n, dtype) == (
                int(wg[3]) if n <= int(lim) else int(wg[4]))
    # the dS rows (4 bytes longer than the step) and the tries of bwd_layout
    assert "const int dsb = kRows * (kStepCh * es + 4);" in src
    assert "lds = kStepCh + 4 / (int)sizeof(T)" in src
    tries = re.search(r"const int tries\[4\]\[3\] = \{(.*?)\};", src)[1]
    assert [tuple(map(int, t.split(","))) for t in
            re.findall(r"\{([\d, ]+)\}", tries)] == [
        (2, 1, 0), (1, 1, 0), (2, 1, 1), (1, 1, 1)]
    # the shared memory sums of both layouts
    assert "L.smem = L.bar_off + 3 * 8;" in src
    assert "L.bar_off = L.epi_off + 4 * L.nwg * 16 * kEpiLd;" in src
    assert "L.bar_off = L.dw_off + (L.dws ? L.sps * per_kb : 0);" in src
    assert "const int per_kb = L.cow / 2 * L.nwr * 32 * 4;" in src
    assert "L.qb = q.piece ? 1 : std::max(1, kStepCh / q.wfull);" in src
    for dtype in (torch.bfloat16, torch.float32):
        es = dcn._es(dtype)
        fl = dcn.narrow_fwd_layout(C, C, DG, dtype)
        assert fl["smem"] == fl["epi_off"] + 4 * fl["nwg"] * 16 * 80 + 24
        assert fl["w_off"] == fl["sc"] * 2 * fl["rows"] * 32
        bl = dcn.narrow_bwd_layout(C, C, DG, dtype)
        assert bl["smem"] == (bl["nw0"] * 64 * es + bl["wtotal"]
                              + 64 * (64 * es + 4) + 64 * 64 * es
                              + bl["sps"] * bl["cow"] // 2 * bl["nwr"] * 128
                              + 24)
