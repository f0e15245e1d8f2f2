"""The DCN kernels' narrow design (``csrc/dcn_narrow.cu``) at 16 channels in
4 deformable groups, the width of the repo's debug configs, on the CPU (its
other widths: ``test_torch_dcn_widths.py``).

The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here, from numpy seeds in f32, at ±4, ±8 and exact:

* (a) the plain forward and backward at this width (what the card's checks
  hold the kernels to), separate and in-place ``om`` forms, against the JAX
  package's exact DCN and ``jax.vjp`` of it;
* (b) a numpy mirror of the kernels' arithmetic: the forward's per (group,
  tap) sums, and the backward's dS, corner products E_k, mask and position
  gradients with the clamp's gates, and its dx scatter of dS * mask *
  (corner weight), against the plain versions;
* (c) the backward's walk (``bwd_grid``): every run of 256 pixels taken by
  one block, each pixel in one run; and the shared memory of both kernels,
  with the constants and expressions these read from ``dcn_narrow.cu``'s
  source.

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


@pytest.mark.parametrize("r", RADII, ids=["r4", "r8", "exact"])
def test_numpy_mirror_of_the_narrow_kernels(r):
    """The kernels' own formulas, in numpy: the forward's masked samples
    times each tap's 4 x 16 weights; the backward's dS = g W^T, E_k = dS .
    corner k, dmask = sum_k w_k E_k, the position gradients as m times
    differences of the E_k behind the clamp's gates, and dx as the scatter
    of dS * m * w_k to each valid corner."""
    x, om, wgt, bias, g = _inputs(10 + (0 if r is None else r))
    b, h, w = x.shape[:3]
    off = om[..., :18 * DG]
    m = 1 / (1 + np.exp(-om[..., 18 * DG:].reshape(b, h, w, DG, 9)))
    ty, tx, cw, cy, cx, valid, gate = _geometry(off, b, h, w, r)
    e = [_corners(x, b, cy[k], cx[k], valid[k]) for k in range(4)]
    val = sum(e[k] * cw[k][..., None] for k in range(4))
    s = val * m[..., None]                          # (b,h,w,g,tap,4)
    wk = wgt.reshape(C, DG, C // DG, 9)             # (co, g, i, tap)
    out = np.einsum("bhwgti,ogit->bhwo", s, wk) + bias
    xt, omt, wt, bt, gt = _t(x, om, wgt, bias, g)
    _close(out, dcn.dcn_fwd_om(xt, omt, wt, bt, DG, None, r), "forward")

    ds = np.einsum("bhwo,ogit->bhwgti", g, wk)
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
    dw = np.einsum("bhwo,bhwgti->ogit", g, s).reshape(C, C, 9)
    pdx, pdoff, pdmask, pdw = dcn.dcn_bwd_plain(
        xt, *split_om(omt, DG), wt, gt, DG, r)
    _close(dx.reshape(b, h, w, C), pdx, "dx")
    _close(doff.reshape(b, h, w, 18 * DG), pdoff, "doffset")
    _close(dm.reshape(b, h, w, 9 * DG), pdmask, "dmask")
    _close(dw, pdw.reshape(C, C, 9), "dweight")


# ---------------------------------------------------------------- (c)


@pytest.mark.parametrize("shape", [(12, 64, 64), (2, 13, 45), (1, 5, 7)],
                         ids=["debug_L1", "ragged", "tiny"])
def test_narrow_bwd_walk_takes_each_run_once(shape):
    b, h, w = shape
    pixels = b * h * w
    for dtype in (torch.bfloat16, torch.float32):
        grid = dcn.bwd_grid(b, h, w, 132, dtype, C, DG)
        runs = [t for grp, tiles in grid for t in tiles]
        assert all(grp is None for grp, _ in grid)  # every group a block
        assert sorted(runs) == list(range(-(-pixels // dcn.NARROW_RUN)))
        assert len(grid) <= dcn.NARROW_BLOCKS_PER_SM * 132
        covered = np.concatenate([np.arange(t * dcn.NARROW_RUN,
                                            (t + 1) * dcn.NARROW_RUN)
                                  for t in runs])
        assert (np.sort(covered[covered < pixels]) == np.arange(pixels)).all()
        # at this width: 48 KB of shared memory at most, and 4 blocks an
        # SM fit
        assert dcn.fwd_smem_bytes(dtype, C, DG) <= 48 * 1024
        smem = dcn.bwd_smem_bytes(dtype, 8, C, DG)
        assert smem <= 48 * 1024
        assert dcn.NARROW_BLOCKS_PER_SM * (smem + 1024) <= 228 * 1024
        assert dcn.narrow_blocks_per_sm(C) == dcn.NARROW_BLOCKS_PER_SM
    # the 64-wide walk is unchanged by the extra arguments' defaults
    assert dcn.bwd_grid(b, h, w, 132, torch.bfloat16) == dcn.bwd_grid(
        b, h, w, 132, torch.bfloat16, dcn.C, dcn.GROUPS)


def test_narrow_constants_are_the_kernel_source():
    """``dcn.py``'s copies of ``dcn_narrow.cu``'s run length, blocks an SM,
    a forward thread's sums, budgets and chunk, and the shared memory of
    both kernels (``fwd_smem`` / ``bwd_smem`` at the plans' tiles and
    chunks), evaluated from the source's expressions."""
    import re

    from realvsr_tpu_torch.ops.kernels import _build

    src = (_build.CSRC / "dcn_narrow.cu").read_text()
    const = {k: eval(v) for k, v in
             re.findall(r"constexpr int (k\w+) = ([\d *]+);", src)}
    assert const["kThreads"] == dcn.NARROW_RUN
    assert const["kBwdBlocksPerSm"] == dcn.NARROW_BLOCKS_PER_SM
    assert const["kCo"] == dcn.NARROW_CO
    assert const["kFwdBudget"] == dcn.NARROW_FWD_BUDGET
    assert const["kBwdBudget"] == dcn.NARROW_BWD_BUDGET
    assert const["kChunkCo"] == dcn.NARROW_CHUNK_CO
    assert "__shared__ float" not in src.replace("extern __shared__ float",
                                                 "")

    def expr(name):
        body = re.search(rf"inline int {name}\(int \w+, int \w+, int \w+\)"
                         r" \{\s*return (.*?);\s*\}", src, re.S).group(1)
        return re.sub(r"\((\w+) \? (\w+) : (\w+)\)", r"(\2 if \1 else \3)",
                      " ".join(body.split()))

    fwd, bwd = expr("fwd_smem"), expr("bwd_smem")
    for cin, cout, dg in ((16, 16, 4), (32, 32, 4), (32, 32, 8), (48, 48, 8),
                          (64, 64, 4), (20, 20, 5), (64, 32, 8), (96, 96, 4),
                          (256, 256, 8), (400, 24, 8)):
        cot, ntap = dcn.narrow_fwd_plan(cin, cout)
        kc, ko, one_co = dcn.narrow_bwd_plan(cin, cout, dg)
        got_fwd = eval(fwd, {}, dict(const, Ci=cin, cot=cot, ntap=ntap))
        got_bwd = eval(bwd, {}, dict(const, kc=kc, ko=ko, one_co=one_co))
        for dtype in (torch.bfloat16, torch.float32):
            assert dcn.fwd_smem_bytes(dtype, cin, dg, cout) == got_fwd
            assert dcn.bwd_smem_bytes(dtype, 8, cin, dg, cout) == got_bwd
    k_c, run, ld = dcn.NARROW[0], dcn.NARROW_RUN, dcn.NARROW[0] + 1
    for dtype in (torch.bfloat16, torch.float32):
        assert dcn.fwd_smem_bytes(dtype, C, DG) == (9 * k_c * k_c + k_c) * 4
        assert dcn.bwd_smem_bytes(dtype, 8, C, DG) == (
            k_c * k_c + 2 * run * ld) * 4
