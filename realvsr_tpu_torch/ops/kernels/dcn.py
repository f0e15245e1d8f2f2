"""Kernels 1 and 2: DCN forward and backward on Hopper
(``csrc/dcn_fwd.cu``, ``csrc/dcn_bwd.cu`` at 64 -> 64 and 128 -> 128
channels in 8 groups with a mask, and ``csrc/dcn_narrow.cu`` at every other
3x3 / s1 / p1 shape: any input and output widths, any groups dividing the
input, with a mask or without one (DCNv1); sampling in
``csrc/dcn_sample.cuh``).

The forward replaces ``realvsr_tpu/ops/pallas/dcn_frame_kernel.py::
dcn_frame_fused`` (input prep ``realvsr_tpu/ops/deform_conv_block.py::
_frame_prep``), the backward ``dcn_frame_kernel.py::dcn_frame_fused_bwd``
with its XLA epilogues ``_fold_dpg`` / ``_fold_dcoord``.  At 64 channels
both are bound on the H100 by memory: the forward moves ~1.1 GB (x,
offsets, mask, out) for 116 GFLOP at the L1 shape (3, 512, 1024, 64); the
backward ~1.25 KB per pixel for 4 * 576 * 64 flop; at 128 the tap products
weigh as much as the bytes.  The forward overlaps the gathers of tap t + 1
with wgmma on tap t (at 64 channels, the weight resident; at 128, sampling
warps and an MMA warpgroup on mbarrier rings, the weight by bulk copies);
the backward takes one deformable group per block, sums dx in a
shared-memory footprint and folds dW into the same pass; see the
sources.
Positions are exact f32: the TPU kernels' int16 fixed-point positions and
lane panels are not carried over.

The wrappers pick the kernel from the tensors' widths (``cin`` input and
``cout`` output channels, ``dg`` deformable groups, a mask or none;
:func:`route`), over the whole domain of the TPU kernel they replace:

* 64 -> 64 and 128 -> 128 in 8 groups with a mask: the wgmma pair
  ``dcn_fwd.cu`` / ``dcn_bwd.cu``;
* every other shape with dg dividing cin (16 in 4, the repo's debug
  configs; 64 -> 32, 96 in 4, 256 in 8, DCNv1 at any width, ...):
  ``dcn_narrow.cu``, an implicit GEMM each way on the tensor cores (the
  sampled matrix S made in shared memory in 32-byte K chunks, each
  (pixel, group, tap) sampled once; the backward's dS and dW on the
  tensor cores too, dW held by each block over its walk), over the K
  layout of :func:`narrow_plan`;
* dg not dividing cin raises a ValueError, as the JAX package cannot run
  it either; nothing falls back to the plain version.

Two forms of the offsets and mask, one kernel each way:

* separate: ``offset`` (B, H, W, dg*18) and ``mask`` (B, H, W, dg*9) after
  the sigmoid, or None (DCNv1: no mask read, none made, no mask gradient)
  — :func:`dcn_fwd`, :func:`dcn_bwd`, :func:`dcn_autograd`;
* in place: ``om``, DCNPack's (B, H, W, dg*27) ``conv_offset_mask`` output
  (offsets in channels [0, dg*18), mask logits after them), read where it
  lies; the kernels take the sigmoid of the logits (rounded to the input
  dtype, as ``torch.sigmoid`` rounds) and the backward writes one
  (B, H, W, dg*27) gradient, the logits' part times s (1 - s) —
  :func:`dcn_fwd_om`, :func:`dcn_bwd_om`, :func:`dcn_om_autograd`.  No
  chunk, concat or sigmoid tensor is made.

Each launches its kernel for a CUDA tensor (or raises on what the kernel
does not take) and counts the launch in ``dcn_fwd.launches`` /
``dcn_bwd.launches``; for a CPU tensor it runs the plain version beside it
(``*_plain``).  Either way a call is one ``kernel.dcn_fwd`` /
``kernel.dcn_bwd`` span (``utils/trace.py``).  The autograd forms undo the
fused activation and bias before the backward kernel, as the JAX package
adds the bias outside its kernel and leaves its gradient to XLA.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from realvsr_tpu_torch.ops.deform_conv import (act_grad,
                                               modulated_deform_conv_plain,
                                               split_om)
from realvsr_tpu_torch.ops.kernels import _build
from realvsr_tpu_torch.utils import trace

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# x, off, off_stride, msk, msk_stride, logits, weight, packed, bias, out,
# B, H, W, C, act, max_off, clamp, stream
_FWD_FUNCS = tuple(
    (f"dcn_fwd_{s}", (_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I,
                      _I, _I, _F, _I, _P))
    for s in _build.SUFFIX.values())
# x, off, off_stride, msk, msk_stride, logits, weight, wt, gout, dx, doff,
# doff_stride, dmsk, dmsk_stride, dw, B, H, W, C, max_off, clamp, rf, stream
_BWD_FUNCS = tuple(
    (f"dcn_bwd_{s}", (_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I, _P,
                      _I, _P, _I, _I, _I, _I, _F, _I, _I, _P))
    for s in _build.SUFFIX.values())
_L = ctypes.c_longlong
# x, off, off_stride, msk, msk_stride, logits, weight, packed, packed_bytes,
# bias, out, B, H, W, Ci, Co, G, act, max_off, clamp, stream; then the
# backward's: x ... packed_bytes, part, part_bytes, gout, dx, doff,
# doff_stride, dmsk, dmsk_stride, dw, B, H, W, Ci, Co, G, max_off, clamp,
# stream
_NARROW_FUNCS = tuple(
    (f"dcn_narrow_fwd_{s}", (_P, _P, _I, _P, _I, _I, _P, _P, _L, _P, _P, _I,
                             _I, _I, _I, _I, _I, _I, _F, _I, _P))
    for s in _build.SUFFIX.values()) + tuple(
    (f"dcn_narrow_bwd_{s}", (_P, _P, _I, _P, _I, _I, _P, _P, _L, _P, _L, _P,
                             _P, _P, _I, _P, _I, _P, _I, _I, _I, _I, _I, _I,
                             _F, _I, _P))
    for s in _build.SUFFIX.values())
C, GROUPS, COUT = 64, 8, 64   # the flagship's width: channels, groups, outputs
WGMMA_WIDTHS = ((64, 8), (128, 8))  # dcn_fwd.cu / dcn_bwd.cu: C -> C, a mask
NARROW = (16, 4)              # the debug configs' width, on dcn_narrow.cu
# dcn_narrow.cu's constants (tests/test_torch_dcn_narrow.py reads them from
# the source): a backward block's threads (one warpgroup) and a wgmma
# m-tile's pixels, a step's input channels at most, the K chunks run in
# one super-step, a super-step's chunks at most otherwise, the outputs of
# a column block / g chunk, the forward's resident weight, streamed slot
# and two A stages, the backward's resident weight and dW partials, an
# epilogue row (bytes)
NARROW_THREADS, NARROW_ROWS, NARROW_STEP_CH = 128, 64, 64
NARROW_ONE_STAGE, NARROW_STAGE_CHUNKS, NARROW_COL_BLOCK = 18, 8, 256
NARROW_FWD_RESIDENT, NARROW_SLOT_BYTES = 48 * 1024, 32 * 1024
NARROW_STAGE_BYTES = 32 * 1024
NARROW_BWD_RESIDENT, NARROW_DW_BUDGET = 64 * 1024, 48 * 1024
NARROW_EPI_LD = 80
NARROW_NW = (8, 16, 32, 64, 128, 256)  # its wgmma N: nw_of
_SMEM_MAX, _SMEM_SM, _LINE = 232448, 228 * 1024, 128
# tile rows of both wgmma kernels at C = 64 (dcn_fwd.cu: Shape::TH,
# dcn_bwd.cu: Layout::TH), of 16 pixels (forward) or 32 (backward); each
# runs one block per SM, of 32 threads a row (:func:`tile_rows` at 128)
TILE_ROWS = {torch.bfloat16: 16, torch.float32: 8}
FWD_TW = 16                   # dcn_fwd.cu: kTW
BWD_TW = 32                   # dcn_bwd.cu: kTW
RF_MAX = 8                    # dcn_bwd.cu: kRfMax
# dcn_fwd.cu's Fwd128 (the 128-channel forward): tile rows (either dtype),
# sampling warps, A stages, weight slots
FWD128_ROWS, FWD128_WARPS, FWD128_STAGES, FWD128_WS = 8, 16, 4, 3
# dcn_bwd.cu's Bwd128 (the 128-channel backward): tile rows, weight taps
# in flight
BWD128_ROWS = {torch.bfloat16: 6, torch.float32: 4}
BWD128_WS = 3


def route(cin: int, cout: int | None = None, dg: int = GROUPS,
          has_mask: bool = True) -> str:
    """The kernel pair that takes ``cin`` -> ``cout`` channels (``cout``
    None: ``cin``) in ``dg`` deformable groups, with a mask or without:
    "wgmma" (C -> C at :data:`WGMMA_WIDTHS`, with a mask), "narrow" (every
    other shape with dg dividing cin: ``dcn_narrow.cu``).  Raises a
    ValueError where dg does not divide cin, which the JAX package cannot
    run either (its offsets are a reshape of the channels into dg groups)."""
    cout = cin if cout is None else cout
    if not (cin >= 1 and cout >= 1 and dg >= 1 and cin % dg == 0):
        raise ValueError(
            f"no DCN for {cin} -> {cout} channels in {dg} deformable "
            "groups: the groups must divide the input channels (as in the "
            "JAX package, whose offsets split the channels into them)")
    if has_mask and cin == cout and (cin, dg) in WGMMA_WIDTHS:
        return "wgmma"
    return "narrow"


def _chunk_of(cpg: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """``dcn_narrow.cu::chunk_of``: channels of a group read at once, the
    largest power of two up to one 16-byte vector dividing ``cpg``."""
    ch = 16 // _es(dtype)
    while cpg % ch:
        ch //= 2
    return ch


def _pad(x: int, m: int) -> int:
    return -(-x // m) * m


def nw_of(w: int) -> int:
    """``dcn_narrow.cu::nw_of``: the wgmma N at least ``w`` wide."""
    return next(n for n in NARROW_NW if n >= w)


@functools.lru_cache(maxsize=None)
def narrow_plan(cin: int, cout: int, dg: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """``dcn_narrow.cu::make_plan``: the K layout of both narrow kernels.
    K runs over (tap, input channel), tap-major; a tap's channels in steps
    of at most :data:`NARROW_STEP_CH`: whole groups where a group fits
    (``gps`` a step), else a group's pieces (``ppg`` steps a group), each
    step zero-padded to whole 32-byte chunks of ``E`` channels (16 bf16, 8
    f32).  ``nr`` steps a tap, ``wfull`` the K of a full step, ``kg`` the K
    of a group's pieces, ``kt`` the K of a tap; ``padded``: some step's
    channels are not whole chunks."""
    cpg = cin // dg
    q = dict(Ci=cin, Co=cout, G=dg, cpg=cpg, ch=_chunk_of(cpg, dtype),
             E=32 // _es(dtype))
    e = q["E"]
    if cpg <= NARROW_STEP_CH:
        gps = min(NARROW_STEP_CH // cpg, dg)
        nr = -(-dg // gps)
        last = cin - (nr - 1) * gps * cpg
        q.update(piece=0, ppg=1, kg=0, gps=gps, nr=nr,
                 wfull=_pad(gps * cpg, e),
                 kt=(nr - 1) * _pad(gps * cpg, e) + _pad(last, e),
                 padded=int((gps * cpg) % e != 0 or last % e != 0))
    else:
        ppg = -(-cpg // NARROW_STEP_CH)
        kg = (ppg - 1) * NARROW_STEP_CH + _pad(
            cpg - (ppg - 1) * NARROW_STEP_CH, e)
        q.update(piece=1, gps=1, ppg=ppg, nr=dg * ppg,
                 wfull=NARROW_STEP_CH, kg=kg, kt=dg * kg,
                 padded=int((cpg - (ppg - 1) * NARROW_STEP_CH) % e != 0))
    return q


def narrow_range(q: dict, j: int) -> tuple[int, int, int]:
    """``dcn_narrow.cu::range_of``: step j of a tap's channels [c0, c1) and
    their K offset in the tap."""
    if not q["piece"]:
        c0 = j * q["gps"] * q["cpg"]
        return c0, min(q["Ci"], c0 + q["gps"] * q["cpg"]), j * q["wfull"]
    g, i = divmod(j, q["ppg"])
    c0 = g * q["cpg"] + i * NARROW_STEP_CH
    return (c0, min(g * q["cpg"] + q["cpg"], c0 + NARROW_STEP_CH),
            g * q["kg"] + i * NARROW_STEP_CH)


def narrow_k_of(q: dict, f: int) -> int:
    """``dcn_narrow.cu::k_of``: the K offset of flat step f (tap f // nr)."""
    tap, j = divmod(f, q["nr"])
    return tap * q["kt"] + narrow_range(q, j)[2]


def narrow_fwd_max_wg(n: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """``dcn_narrow.cu::fwd_max_wg``: warpgroups a forward block at most
    (4 at N <= 64 in bf16, 32 in f32, else 2: 128 registers a thread, or
    255)."""
    return 4 if n <= (64 if dtype == torch.bfloat16 else 32) else 2


@functools.lru_cache(maxsize=None)
def narrow_fwd_layout(cin: int, cout: int, dg: int,
                      dtype: torch.dtype) -> dict:
    """``dcn_narrow.cu::fwd_layout``: the forward's N (outputs padded to a
    power of two up to 256), column blocks, warpgroups of a block (``nwg``:
    the most whose shared memory fits; each a 64-row m-tile of the tile's
    ``rows`` pixels), whether a block's packed weight is resident, the
    steps of a super-step (all where the tile's K is
    :data:`NARROW_ONE_STAGE` chunks or fewer, both stages within
    :data:`NARROW_STAGE_BYTES` and the weight resident or within a slot),
    the K chunks of an A stage, the packed weight's bytes a column block,
    and the shared memory: two A stages, the weight (resident, or two
    slots), the warps' 16 epilogue rows each, three mbarriers.  Cached: the
    wrappers read it at every call."""
    q = narrow_plan(cin, cout, dg, dtype)
    n = NARROW_COL_BLOCK if cout > NARROW_COL_BLOCK else nw_of(cout)
    nb = -(-cout // n)
    chunks = 9 * q["kt"] // q["E"]
    wbytes = chunks * n * 32
    resident = nb == 1 and wbytes <= NARROW_FWD_RESIDENT
    step_chunks = q["wfull"] // q["E"]
    nwg = narrow_fwd_max_wg(n, dtype)
    while True:
        rows = NARROW_ROWS * nwg
        per_chunk = 2 * rows * 32
        if (chunks <= NARROW_ONE_STAGE
                and chunks * per_chunk <= NARROW_STAGE_BYTES
                and (resident or chunks * n * 32 <= NARROW_SLOT_BYTES)):
            qs = 9 * q["nr"]
        else:
            qs = max(1, min(NARROW_STAGE_CHUNKS // step_chunks,
                            NARROW_STAGE_BYTES // (step_chunks * per_chunk)))
            if not resident:
                qs = min(qs, max(1, NARROW_SLOT_BYTES
                                 // (step_chunks * n * 32)))
            qs = min(qs, 9 * q["nr"])
        sc = qs * step_chunks
        w_off = sc * per_chunk
        epi_off = w_off + (wbytes if resident else 2 * sc * n * 32)
        bar_off = epi_off + 4 * nwg * 16 * NARROW_EPI_LD
        if bar_off + 24 <= _SMEM_MAX or nwg == 1:
            break
        nwg //= 2
    return dict(N=n, nb=nb, nwg=nwg, rows=rows, resident=int(resident),
                qs=qs, nsuper=-(-9 * q["nr"] // qs), sc=sc, wbytes=wbytes,
                w_off=w_off, epi_off=epi_off, bar_off=bar_off,
                smem=bar_off + 24, packed_bytes=nb * wbytes)


@functools.lru_cache(maxsize=None)
def narrow_bwd_layout(cin: int, cout: int, dg: int,
                      dtype: torch.dtype) -> dict:
    """``dcn_narrow.cu::bwd_layout``: the K-blocks (``qb`` consecutive
    steps of at most 64 channel rows, step i at rows i * wfull; one a block
    where a step is a group's piece; ``nkb`` of them), the g chunks
    (``gch`` outputs, at most :data:`NARROW_COL_BLOCK`; ``nw0`` / ``nwl``
    the wgmma N of a full and of the last one, ``cow`` their sum), the
    packed weight's bytes (``wtotal``: [K-block][co chunk][64 channel
    rows][32 bytes]), resident or streamed through ``nslot`` slots, the
    warps that hold a K-block's rows (``nwr``), the K-blocks of a slice
    (``sps``: the dW a block holds; ``part`` bytes of partials), whether
    the partials sit in shared memory (``dws``) or in the block's slot of
    a global scratch, and the shared memory: the g tile, the weight, dS
    (rows 4 bytes longer than 64 elements), S^T, the partials, three
    mbarriers.  Cached."""
    q = narrow_plan(cin, cout, dg, dtype)
    es = _es(dtype)
    qb = 1 if q["piece"] else max(1, NARROW_STEP_CH // q["wfull"])
    nkb = -(-9 * q["nr"] // qb)
    gch = min(_pad(cout, q["E"]), NARROW_COL_BLOCK)
    ngc = -(-cout // gch)
    nw0 = nw_of(gch)
    nwl = nw_of(_pad(cout - (ngc - 1) * gch, q["E"]))
    cow = (ngc - 1) * nw0 + nwl
    wtotal = nkb * cow // q["E"] * NARROW_ROWS * 32
    resident = wtotal <= NARROW_BWD_RESIDENT
    nwr = -(-qb * q["wfull"] // 16)
    gbytes = nw0 * NARROW_ROWS * es
    slot = nw0 // q["E"] * NARROW_ROWS * 32
    dsb = NARROW_ROWS * (NARROW_STEP_CH * es + 4)
    stb = NARROW_ROWS * NARROW_STEP_CH * es
    per_kb = cow // 2 * nwr * 32 * 4
    unit = q["ppg"] if q["piece"] else 1
    want = max(1, NARROW_DW_BUDGET // (per_kb * unit)) * unit
    dws, nslot, sps = 0, 1, unit
    for n_slot, fewest in ((2, 0), (1, 0), (2, 1), (1, 1)):
        steps = unit if fewest else min(want, nkb)
        w = wtotal if resident else n_slot * slot
        if gbytes + w + dsb + stb + steps * per_kb + 24 <= _SMEM_MAX:
            dws, nslot, sps = 1, n_slot, steps
            break
    if not dws:
        w2 = wtotal if resident else 2 * slot
        nslot = 2 if gbytes + w2 + dsb + stb + 24 <= _SMEM_MAX else 1
    w_off = gbytes
    ds_off = w_off + (wtotal if resident else nslot * slot)
    st_off = ds_off + dsb
    dw_off = st_off + stb
    bar_off = dw_off + (sps * per_kb if dws else 0)
    return dict(qb=qb, nkb=nkb, gch=gch, ngc=ngc, nw0=nw0, nwl=nwl,
                cow=cow, resident=int(resident), nslot=nslot, wtotal=wtotal,
                nwr=nwr, sps=sps, nslices=-(-nkb // sps), dws=dws,
                part=sps * per_kb,
                w_off=w_off, ds_off=ds_off, st_off=st_off, dw_off=dw_off,
                bar_off=bar_off, smem=bar_off + 24, packed_bytes=wtotal)


def narrow_channel_at(q: dict, k: int) -> int:
    """``dcn_narrow.cu::channel_at``: the channel at K offset ``k`` of a
    tap, or -1 in the padding."""
    if not q["piece"]:
        j, off = divmod(k, q["wfull"])
        if j >= q["nr"]:
            return -1
    else:
        g, r = divmod(k, q["kg"])
        i = min(r // NARROW_STEP_CH, q["ppg"] - 1)
        j, off = g * q["ppg"] + i, r - i * NARROW_STEP_CH
    c0, c1, _ = narrow_range(q, j)
    return c0 + off if c0 + off < c1 else -1


def narrow_sw32_at(r: int, k: int, rows: int, es: int) -> int:
    """``dcn_narrow.cu::sw32_at``: the byte of element k of row r in a
    32-byte-swizzled K-major image of ``rows`` rows ([k // E][r][32
    bytes], 16-byte unit u of row r at u ^ ((r >> 2) & 1): the layout of
    ``desc_sw32``)."""
    u = 16 // es
    e, w = 2 * u, k % (2 * u)
    return ((k // e) * rows * 32 + r * 32 + (((w // u) ^ ((r >> 2) & 1)) << 4)
            + (w % u) * es)


def narrow_tiles(h: int, w: int, rows: int) -> tuple[int, int, int, int]:
    """``dcn_narrow.cu::tiles_of``: (tiles_x, tiles_y, th, tw) of tiles of
    ``rows`` pixels, ``tw`` 16 or the width rounded up to a power of
    two."""
    tw = 1
    while tw < min(w, 16):
        tw *= 2
    th = rows // tw
    return -(-w // tw), -(-h // th), th, tw


def narrow_tile_pixels(tile: int, h: int, w: int, rows: int) -> list[int]:
    """``tile_at`` / ``pixel_at``: the pixel index of each row of a tile
    (tile = (b * tiles_y + ty) * tiles_x + tx), -1 outside the image."""
    tiles_x, tiles_y, th, tw = narrow_tiles(h, w, rows)
    rest, tx = divmod(tile, tiles_x)
    b, ty = divmod(rest, tiles_y)
    out = []
    for r in range(rows):
        y, x = ty * th + r // tw, tx * tw + r % tw
        out.append((b * h + y) * w + x if y < h and x < w else -1)
    return out


def narrow_items(q: dict, rows: int, threads: int, f0: int,
                 nf: int) -> list[list[tuple[int, int, int, int, int]]]:
    """The sampling walk (``walk_of`` / ``items_of`` / ``item_at``) of
    steps [f0, f0 + nf) of a tile of ``rows`` pixels: for each thread, its
    items (row, step, group, lo, hi) in order, groups fastest across a
    power of two of lanes a pixel (at most 32), rows, then steps."""
    lpp = 1
    while lpp < q["gps"] and lpp < 32:
        lpp *= 2
    nj = -(-q["gps"] // lpp)
    slots = nf * rows * lpp
    cpg = q["cpg"]
    out = []
    for t in range(threads):
        cnt = ((slots - 1 - t) // threads + 1) * nj if t < slots else 0
        items = []
        for m in range(cnt):
            n, j = divmod(m, nj)
            it = t + threads * n
            slot, gi = it // lpp, it % lpp + j * lpp
            r, f = slot % rows, f0 + slot // rows
            jj = f % q["nr"]
            c0, c1, _ = narrow_range(q, jj)
            grp = jj // q["ppg"] if q["piece"] else jj * q["gps"] + gi
            lo, hi = max(c0, grp * cpg), min(c1, grp * cpg + cpg)
            if gi < q["gps"] and lo < hi:
                items.append((r, f, grp, lo, hi))
        out.append(items)
    return out


def _rounded_mma(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    from realvsr_tpu_torch.ops.kernels.conv3x3 import round_tf32
    return round_tf32(t.float()) if dtype == torch.float32 else t.to(dtype)


def narrow_pack_fwd(weight: torch.Tensor, dg: int) -> torch.Tensor:
    """``dcn_narrow.cu::pack_fwd`` in plain PyTorch: the forward's packed
    weight, [column block][K chunk][N rows][E elements], each 32-byte row's
    16-byte units swizzled, zero in the padding and past cout, rounded as
    the tensor cores take it (TF32 for f32); flat, in the weight's
    dtype."""
    cout, cin = weight.shape[:2]
    dt = weight.dtype
    q, lay = narrow_plan(cin, cout, dg, dt), narrow_fwd_layout(cin, cout,
                                                               dg, dt)
    n, e, u = lay["N"], q["E"], 16 // _es(dt)
    chunks = 9 * q["kt"] // e
    idx = np.arange(lay["nb"] * chunks * n * e)
    pos, rest = idx % e, idx // e
    nn, rest = rest % n, rest // n
    kk, cb = rest % chunks, rest // chunks
    k = kk * e + ((pos // u) ^ ((nn >> 2) & 1)) * u + pos % u
    tap, kin = k // q["kt"], k % q["kt"]
    ch = np.array([narrow_channel_at(q, i) for i in range(q["kt"])])[kin]
    co = cb * n + nn
    wf = weight.detach().float().cpu().numpy()
    ok = (ch >= 0) & (co < cout)
    vals = np.where(ok, wf[np.minimum(co, cout - 1), np.maximum(ch, 0),
                           tap // 3, tap % 3], 0.0)
    return _rounded_mma(torch.from_numpy(vals.astype(np.float32)), dt)


def narrow_pack_bwd(weight: torch.Tensor, dg: int) -> torch.Tensor:
    """``dcn_narrow.cu::pack_bwd`` in plain PyTorch: the backward's packed
    weight, [K-block][co chunk][64 channel rows][E elements] (row n: channel
    n % wfull of the block's step n // wfull; each g chunk's outputs padded
    to its wgmma N), swizzled, zero in the padding, rounded as the tensor
    cores take it; flat, in the weight's dtype."""
    cout, cin = weight.shape[:2]
    dt = weight.dtype
    q, lay = narrow_plan(cin, cout, dg, dt), narrow_bwd_layout(cin, cout,
                                                               dg, dt)
    e, u = q["E"], 16 // _es(dt)
    chunks = lay["cow"] // e
    idx = np.arange(lay["nkb"] * chunks * NARROW_ROWS * e)
    pos, rest = idx % e, idx // e
    nn, rest = rest % NARROW_ROWS, rest // NARROW_ROWS
    kk, kb = rest % chunks, rest // chunks
    cw = kk * e + ((pos // u) ^ ((nn >> 2) & 1)) * u + pos % u
    gc = np.minimum(cw // lay["nw0"], lay["ngc"] - 1)
    off = cw - gc * lay["nw0"]
    co = gc * lay["gch"] + off
    sub = nn // q["wfull"]
    f = kb * lay["qb"] + sub
    fv = np.minimum(f, 9 * q["nr"] - 1)
    tap, j = fv // q["nr"], fv % q["nr"]
    ranges = np.array([narrow_range(q, i)[:2] for i in range(q["nr"])])
    c = ranges[j, 0] + nn - sub * q["wfull"]
    ok = ((sub < lay["qb"]) & (f < 9 * q["nr"]) & (off < lay["gch"])
          & (co < cout) & (c < ranges[j, 1]))
    wf = weight.detach().float().cpu().numpy()
    vals = np.where(ok, wf[np.minimum(co, cout - 1), np.minimum(c, cin - 1),
                           tap // 3, tap % 3], 0.0)
    return _rounded_mma(torch.from_numpy(vals.astype(np.float32)), dt)


def tile_rows(dtype: torch.dtype, c: int = C, bwd: bool = False) -> int:
    """Tile rows of the wgmma pair at C channels (64 or 128): of the
    forward (``dcn_fwd.cu``: Shape::TH; at 128 Fwd128::TH, 8), or of the
    backward (``dcn_bwd.cu``: Layout::TH; at 128 Bwd128::TH, 6 bf16 / 4
    f32)."""
    if c == 128:
        return BWD128_ROWS[dtype] if bwd else FWD128_ROWS
    return TILE_ROWS[dtype]


def _es(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def fwd_smem_bytes(dtype: torch.dtype, c: int = C, dg: int = GROUPS,
                   cout: int | None = None, has_mask: bool = True) -> int:
    """Shared memory of a forward block: at 64 channels
    ``dcn_fwd.cu::Shape::kSmem`` (the packed weight, resident, and two A
    stages of a tile's pixels); at 128 ``Fwd128::kSmem`` (a ring of A
    stages, one 128-byte chunk of a tile's pixels each, a ring of weight
    slots, one chunk of a tap for the 128 outputs each, the MMA warps'
    epilogue rows of 16 pixels x (128 + 16) bytes, and the mbarriers); on
    ``dcn_narrow.cu`` :func:`narrow_fwd_layout`'s."""
    cout = c if cout is None else cout
    if route(c, cout, dg, has_mask) == "narrow":
        return narrow_fwd_layout(c, cout, dg, dtype)["smem"]
    px = tile_rows(dtype, c) * FWD_TW
    if c == 128:
        return (FWD128_STAGES * px * _LINE + FWD128_WS * c * _LINE
                + 4 * 16 * (_LINE + 16) + 8 * (2 * FWD128_STAGES + FWD128_WS))
    chunks = c * _es(dtype) // _LINE
    return 9 * chunks * c * _LINE + 2 * chunks * px * _LINE


def fwd128_items(dtype: torch.dtype, chunk: int, warp: int,
                 lane: int) -> list[tuple[int, int, int, int]]:
    """``dcn_fwd_kernel128``'s sampling assignment: for each of a sampling
    lane's items at a step on 128-byte input ``chunk``, its (A stage row,
    i.e. the tile's pixel, 16-byte unit of the row, first channel,
    deformable group): lane l of warp w takes unit l % 8 of pixels 4 n w +
    4 j + l // 8, j < n, with n = 2 items a lane (:data:`FWD128_WARPS`
    warps over a tile of :data:`FWD128_ROWS` x :data:`FWD_TW` pixels)."""
    es = _es(dtype)
    n = FWD128_ROWS * FWD_TW * (_LINE // 16) // (32 * FWD128_WARPS)
    u, q0 = lane % 8, lane // 8
    ch0 = chunk * (_LINE // es) + u * (16 // es)
    return [(4 * n * warp + 4 * j + q0, u, ch0,
             (chunk * _LINE + u * 16) // (16 * es)) for j in range(n)]


def fwd128_grid(b: int, h: int, w: int, sms: int) -> list[list[int]]:
    """``dcn_fwd_kernel128``'s walk: block i of min(ntiles, sms) takes
    tiles i, i + grid, ...; a tile is ``(b * tiles_y + ty) * tiles_x + tx``
    of :data:`FWD128_ROWS` x :data:`FWD_TW` pixels."""
    ntiles = b * -(-h // FWD128_ROWS) * -(-w // FWD_TW)
    grid = min(ntiles, sms)
    return [list(range(i, ntiles, grid)) for i in range(grid)]


def footprint_radius(max_offset: float | None) -> int:
    """The backward's dx footprint radius: every corner of a tile with
    offsets clamped to ±R lies within ceil(R) + 1 (+ 2 below and right) of
    it; beyond :data:`RF_MAX`, and with no clamp, corners outside go to the
    global path."""
    if max_offset is None:
        return RF_MAX
    return min(max(math.ceil(float(max_offset)), 0), RF_MAX)


def footprint(tile_y0: int, tile_x0: int, rf: int, th: int):
    """(y0, x0, rows, cols) of the footprint of the backward tile of ``th``
    rows whose first pixel is (tile_y0, tile_x0) (``dcn_bwd.cu``: fy0, fx0,
    fh, fw)."""
    return (tile_y0 - 1 - rf, tile_x0 - 1 - rf, th + 2 * rf + 3,
            BWD_TW + 2 * rf + 3)


def bwd_smem_bytes(dtype: torch.dtype, rf: int, c: int = C,
                   dg: int = GROUPS, cout: int | None = None,
                   has_mask: bool = True) -> int:
    """Shared memory of a backward block: at 64 channels
    ``dcn_bwd.cu::smem_bytes`` (the group's weight, the g tile, dS, two S
    buffers, the block reduction); at 128 ``Bwd128::smem`` (the TMA'd g
    tile, a ring of weight taps, two S and two dS slots, the sampling
    warps' reduction, the mbarriers); then the dx footprint of C
    / 8 + 1 ints a pixel.  On ``dcn_narrow.cu`` (no footprint)
    :func:`narrow_bwd_layout`'s."""
    cout = c if cout is None else cout
    if route(c, cout, dg, has_mask) == "narrow":
        return narrow_bwd_layout(c, cout, dg, dtype)["smem"]
    es = _es(dtype)
    pad, cpg = 16 // es, c // GROUPS
    th = tile_rows(dtype, c, bwd=True)
    px = th * BWD_TW
    if c == 64:
        fixed = (9 * cpg * (c + pad) * es + px * (c + pad) * es
                 + px * cpg * 4 + 2 * cpg * (px + pad) * es + px // 32 * 4)
    else:
        chunks = c * es // _LINE
        bars = 1 + BWD128_WS + 6
        fixed = (chunks * px * _LINE
                 + BWD128_WS * chunks * cpg * _LINE
                 + 2 * cpg * (px + pad) * es + 2 * px * cpg * es
                 + 2 * px // 32 * 8 + bars * 8 + 15) // 16 * 16
    _, _, fh, fw = footprint(0, 0, rf, th)
    return fixed + fh * fw * (cpg + 1) * 4


def narrow_blocks_per_sm(c: int, cout: int | None = None, dg: int = 1,
                         dtype: torch.dtype = torch.bfloat16) -> int:
    """Backward blocks an SM of ``dcn_narrow.cu`` at ``c`` -> ``cout``
    channels in ``dg`` groups as shared memory allows (the kernel sizes its
    grid by the card's occupancy, which registers may cut further), at
    most 2048 threads an SM."""
    cout = c if cout is None else cout
    smem = narrow_bwd_layout(c, cout, dg, dtype)["smem"]
    return min(2048 // NARROW_THREADS, _SMEM_SM // (smem + 1024))


def narrow_walk(items: int, blocks: int) -> list[list[int]]:
    """Both narrow kernels' persistent walk: block i of ``blocks`` takes the
    items [i * items // blocks, (i + 1) * items // blocks)."""
    return [list(range(i * items // blocks, (i + 1) * items // blocks))
            for i in range(blocks)]


def bwd_grid(b: int, h: int, w: int, sms: int, dtype: torch.dtype,
             c: int = C, dg: int = GROUPS, cout: int | None = None,
             has_mask: bool = True):
    """The backward's walk: for each block of its grid, (group, tiles); a
    tile is ``(b * tiles_y + ty) * tiles_x + tx`` (``dcn_bwd.cu``).  At 128
    channels a block takes a run of (group, tile) items (group None; its
    tiles are the items' (group, tile) pairs): item j = group * ntiles +
    tile, block i of min(8 * ntiles, sms) the items [i * n // blocks, (i +
    1) * n // blocks).  On ``dcn_narrow.cu`` a block takes every group
    (group None) and its tiles are its (slice, tile) items (item = slice *
    ntiles + tile, :func:`narrow_walk`), a tile :data:`NARROW_ROWS` pixels
    (:func:`narrow_tile_pixels`) and a slice ``sps`` steps of the K layout
    (:func:`narrow_bwd_layout`)."""
    cout = c if cout is None else cout
    if route(c, cout, dg, has_mask) == "narrow":
        tiles_x, tiles_y, _, _ = narrow_tiles(h, w, NARROW_ROWS)
        ntiles = b * tiles_x * tiles_y
        items = narrow_bwd_layout(c, cout, dg, dtype)["nslices"] * ntiles
        blocks = min(items, narrow_blocks_per_sm(c, cout, dg, dtype) * sms)
        return [(None, [divmod(i, ntiles) for i in run])
                for run in narrow_walk(items, blocks)]
    th = tile_rows(dtype, c, bwd=True)
    ntiles = b * -(-h // th) * -(-w // BWD_TW)
    if c == 128:
        n = GROUPS * ntiles
        blocks = min(n, sms)
        return [(None, [divmod(j, ntiles) for j in range(
            i * n // blocks, (i + 1) * n // blocks)]) for i in range(blocks)]
    slots = min(ntiles, sms // GROUPS)
    return [(i % GROUPS, list(range(i // GROUPS, ntiles, slots)))
            for i in range(slots * GROUPS)]


def _clamp_args(max_offset):
    return (0.0, 0) if max_offset is None else (float(max_offset), 1)


def _check_x(name, x, weight, dg, has_mask):
    """Validate the input both kernels read; returns (b, h, w, cin, cout,
    route)."""
    if not x.is_cuda:
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dtype not in _build.SUFFIX:
        raise ValueError(f"{name}: dtype {x.dtype} not supported")
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, H, W, C)")
    b, h, w, c = x.shape
    cout = weight.shape[0]
    try:
        kernel = route(c, cout, dg, has_mask)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{name}: {b * h * w} pixels exceed 32-bit indices")
    _build.check_tensor(x, "x", (b, h, w, c), x.dtype, x.device)
    _build.check_tensor(weight, "weight", (cout, c, 3, 3), x.dtype, x.device)
    return b, h, w, c, cout, kernel


def _sources(x, offset, mask, om, dg):
    """(offset ptr, its pixel stride, mask ptr, its stride, logits) for the
    kernels, after checking the tensors they come from, and what must live
    until the launch.  The kernels load each (dy, dx) pair as one vector,
    so offset rows must be an even number of elements apart: ``om`` in an
    odd number of groups (rows of 27 dg) has its offsets copied, its mask
    logits read in place."""
    b, h, w, _ = x.shape
    dt, dev = x.dtype, x.device
    if om is not None:
        _build.check_tensor(om, "om", (b, h, w, dg * 27), dt, dev)
        mask_ptr = om.data_ptr() + dg * 18 * om.element_size()
        if dg % 2:
            off = om[..., :dg * 18].contiguous()
            return (off.data_ptr(), dg * 18, mask_ptr, dg * 27, 1), off
        return (om.data_ptr(), dg * 27, mask_ptr, dg * 27, 1), None
    _build.check_tensor(offset, "offset", (b, h, w, dg * 18), dt, dev)
    if mask is None:   # DCNv1: the kernel reads no mask
        return (offset.data_ptr(), dg * 18, None, 0, 0), None
    _build.check_tensor(mask, "mask", (b, h, w, dg * 9), dt, dev)
    return (offset.data_ptr(), dg * 18, mask.data_ptr(), dg * 9, 0), None


def _launch_fwd(x, offset, mask, om, weight, bias, dg, act, max_offset):
    if act not in _build.ACTS:
        raise ValueError(f"dcn_fwd: unknown activation {act!r}")
    has_mask = om is not None or mask is not None
    b, h, w, c, cout, kernel = _check_x("dcn_fwd", x, weight, dg, has_mask)
    src, _keep = _sources(x, offset, mask, om, dg)
    dt, dev = x.dtype, x.device
    if fwd_smem_bytes(dt, c, dg, cout, has_mask) > _SMEM_MAX:
        raise ValueError("dcn_fwd: shared memory exceeded")
    if bias is not None:
        _build.check_tensor(bias, "bias", (cout,), dt, dev)
    out = torch.empty(b, h, w, cout, device=dev, dtype=dt)
    sfx = _build.SUFFIX[dt]
    if kernel == "narrow":
        fn = getattr(_build.load("dcn_narrow", _NARROW_FUNCS),
                     f"dcn_narrow_fwd_{sfx}")
        nbytes = narrow_fwd_layout(c, cout, dg, dt)["packed_bytes"]
        packed = torch.empty(nbytes, device=dev, dtype=torch.uint8)
        weights = (weight.data_ptr(), packed.data_ptr(), nbytes)
        widths = (c, cout, dg)
    else:
        packed = torch.empty(c * 9 * c, device=dev, dtype=dt)
        fn = getattr(_build.load("dcn_fwd", _FWD_FUNCS), f"dcn_fwd_{sfx}")
        weights, widths = (weight.data_ptr(), packed.data_ptr()), (c,)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), *src, *weights,
                  None if bias is None else bias.data_ptr(), out.data_ptr(),
                  b, h, w, *widths, _build.ACTS[act],
                  *_clamp_args(max_offset),
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dcn_fwd")
    return out


def dcn_fwd_plain(x, offset, mask, weight, bias=None, deformable_groups=8,
                  act=None, max_offset=None):
    """The forward kernel's function in plain PyTorch (3x3 / s1 / p1; mask
    None: DCNv1)."""
    return modulated_deform_conv_plain(
        x, offset, mask, weight, bias, 1, 1, 1, deformable_groups,
        max_offset, act)


def dcn_fwd_om_plain(x, om, weight, bias=None, deformable_groups=8,
                     act=None, max_offset=None):
    """:func:`dcn_fwd_plain` from DCNPack's offset/mask tensor ``om``."""
    return dcn_fwd_plain(x, *split_om(om, deformable_groups), weight, bias,
                         deformable_groups, act, max_offset)


def dcn_fwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, bias: torch.Tensor | None = None,
            deformable_groups: int = 8, act: str | None = None,
            max_offset: float | None = None) -> torch.Tensor:
    """DCN 3x3 / s1 / p1 forward (DCNv2, or DCNv1 with no mask) with fused
    bias and activation.

    x: (B, H, W, Cin) contiguous NHWC; offset: (B, H, W, dg*9*2) laid out
    (dg, tap, (dy, dx)); mask: (B, H, W, dg*9) after the sigmoid, or None
    (DCNv1); weight (Cout, Cin, 3, 3); bias (Cout,) or None; act None /
    "relu" / "lrelu"; max_offset None (exact) or R (offsets clamped to [-R,
    R]); any widths with dg dividing Cin (:func:`route`).  All of one
    dtype, bf16 or f32 (f32 runs the tensor cores in TF32).  Traced as a
    ``kernel.dcn_fwd`` span (:func:`realvsr_tpu_torch.utils.trace.kernel`),
    as :func:`dcn_fwd_om` is.
    """
    with trace.kernel("kernel.dcn_fwd", x, weight,
                      groups=deformable_groups, act=act):
        if x.device.type == "cpu":
            return dcn_fwd_plain(x, offset, mask, weight, bias,
                                 deformable_groups, act, max_offset)
        out = launch_fwd(x, offset, mask, weight, bias, deformable_groups,
                         act, max_offset)
        dcn_fwd.launches += 1
        return out


def dcn_fwd_om(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None, deformable_groups: int = 8,
               act: str | None = None,
               max_offset: float | None = None) -> torch.Tensor:
    """:func:`dcn_fwd` with the offsets and mask logits read in place from
    ``om`` (B, H, W, dg*27); counted in ``dcn_fwd.launches``."""
    with trace.kernel("kernel.dcn_fwd", x, weight,
                      groups=deformable_groups, act=act):
        if x.device.type == "cpu":
            return dcn_fwd_om_plain(x, om, weight, bias, deformable_groups,
                                    act, max_offset)
        out = _launch_fwd(x, None, None, om, weight, bias, deformable_groups,
                          act, max_offset)
        dcn_fwd.launches += 1
        return out


def launch_fwd(x, offset, mask, weight, bias, deformable_groups, act,
               max_offset) -> torch.Tensor:
    """Check the CUDA tensors and launch the forward kernel on the separate
    offsets and mask; the caller counts the launch (:func:`dcn_fwd`, or the
    block API of ``ops/deform_conv_block.py``, which counts its own)."""
    return _launch_fwd(x, offset, mask, None, weight, bias,
                       deformable_groups, act, max_offset)


dcn_fwd.launches = 0


def _grads(x, offset, mask, om, weight, g, deformable_groups, max_offset):
    """Autograd of the plain op (no bias, no activation) for the output
    cotangent ``g``, w.r.t. x, the offsets and mask (or ``om``) and the
    weight; the mask's None where there is none."""
    with torch.enable_grad():
        srcs = (offset, mask) if om is None else (om,)
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in (x, *srcs, weight)]
        off_mask = (leaves[1:3] if om is None
                    else split_om(leaves[1], deformable_groups))
        out = modulated_deform_conv_plain(
            leaves[0], *off_mask, leaves[-1], None, 1, 1, 1,
            deformable_groups, max_offset, None)
        got = iter(torch.autograd.grad(
            out, [t for t in leaves if t is not None], g))
        return tuple(None if t is None else next(got) for t in leaves)


def dcn_bwd_plain(x, offset, mask, weight, g, deformable_groups=8,
                  max_offset=None):
    """The backward kernel's function in plain PyTorch: the gradients of
    :func:`modulated_deform_conv_plain` (no bias, no activation) with
    output cotangent ``g``.  Returns (dx, doffset, dmask, dweight), dmask
    None where mask is None."""
    return _grads(x, offset, mask, None, weight, g, deformable_groups,
                  max_offset)


def dcn_bwd_om_plain(x, om, weight, g, deformable_groups=8,
                     max_offset=None):
    """:func:`dcn_bwd_plain` from ``om``: the gradients through DCNPack's
    split and sigmoid.  Returns (dx, dom, dweight), dom (B, H, W, dg*27)."""
    return _grads(x, None, None, om, weight, g, deformable_groups,
                  max_offset)


def _launch_bwd(x, offset, mask, om, weight, g, dg, max_offset):
    has_mask = om is not None or mask is not None
    b, h, w, c, cout, kernel = _check_x("dcn_bwd", x, weight, dg, has_mask)
    src, _keep = _sources(x, offset, mask, om, dg)
    dt, dev = x.dtype, x.device
    rf = footprint_radius(max_offset)
    if bwd_smem_bytes(dt, rf, c, dg, cout, has_mask) > _SMEM_MAX:
        raise ValueError("dcn_bwd: shared memory exceeded")
    _build.check_tensor(g, "g", (b, h, w, cout), dt, dev)
    dx = torch.zeros(b, h, w, c, device=dev, dtype=torch.float32)
    dw = torch.zeros(cout, 9, c, device=dev, dtype=torch.float32)
    if om is None:
        doffset = torch.empty_like(offset)
        dmask = None if mask is None else torch.empty_like(mask)
        dsts = (doffset.data_ptr(), dg * 18,
                None if dmask is None else dmask.data_ptr(), dg * 9)
    else:
        dom = torch.empty_like(om)
        dsts = (dom.data_ptr(), dg * 27,
                dom.data_ptr() + dg * 18 * dom.element_size(), dg * 27)
    sfx = _build.SUFFIX[dt]
    if kernel == "narrow":
        fn = getattr(_build.load("dcn_narrow", _NARROW_FUNCS),
                     f"dcn_narrow_bwd_{sfx}")
        lay = narrow_bwd_layout(c, cout, dg, dt)
        nbytes = lay["packed_bytes"]
        wt = torch.empty(nbytes, device=dev, dtype=torch.uint8)
        part = None
        if not lay["dws"]:  # dW partials in global memory: a slot a block
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            part = torch.zeros(sms * narrow_blocks_per_sm(c, cout, dg, dt)
                               * lay["part"] // 4, device=dev,
                               dtype=torch.float32)
        weights = (weight.data_ptr(), wt.data_ptr(), nbytes,
                   None if part is None else part.data_ptr(),
                   0 if part is None else part.numel() * 4)
        widths, radius = (c, cout, dg), ()
    else:   # at 128 channels the kernel lays the weight out in wt first
        wt = torch.empty(c * 9 * c, device=dev, dtype=dt) if c == 128 else None
        fn = getattr(_build.load("dcn_bwd", _BWD_FUNCS), f"dcn_bwd_{sfx}")
        weights = (weight.data_ptr(), None if wt is None else wt.data_ptr())
        widths, radius = (c,), (rf,)
    with torch.cuda.device(dev):
        code = fn(x.data_ptr(), *src, *weights, g.data_ptr(),
                  dx.data_ptr(), *dsts, dw.data_ptr(), b, h, w, *widths,
                  *_clamp_args(max_offset), *radius,
                  torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "dcn_bwd")
    dcn_bwd.launches += 1
    dweight = dw.view(cout, 3, 3, c).permute(0, 3, 1, 2).to(dt)
    if om is None:
        return dx.to(dt), doffset, dmask, dweight
    return dx.to(dt), dom, dweight


def dcn_bwd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
            weight: torch.Tensor, g: torch.Tensor,
            deformable_groups: int = 8, max_offset: float | None = None):
    """DCN 3x3 / s1 / p1 backward: (dx, doffset, dmask, dweight) for the
    output cotangent ``g`` (B, H, W, Cout), taken before bias and
    activation; dmask None where mask is None (DCNv1).

    Same inputs and layouts as :func:`dcn_fwd`.  dx and dweight are summed
    in f32 with atomics (the order of the sums changes from run to run) and
    cast to the input dtype; doffset is zero where the clamp cut the offset
    (the gate passes on [-R, R] inclusive).  Traced as a ``kernel.dcn_bwd``
    span, as :func:`dcn_bwd_om` is.
    """
    with trace.kernel("kernel.dcn_bwd", x, weight, groups=deformable_groups):
        if x.device.type == "cpu":
            return dcn_bwd_plain(x, offset, mask, weight, g,
                                 deformable_groups, max_offset)
        return _launch_bwd(x, offset, mask, None, weight, g,
                           deformable_groups, max_offset)


def dcn_bwd_om(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
               g: torch.Tensor, deformable_groups: int = 8,
               max_offset: float | None = None):
    """:func:`dcn_bwd` from ``om``: (dx, dom, dweight), dom the gradient of
    ``om`` (B, H, W, dg*27) — the offset gradient as it is and the mask
    gradient times s (1 - s); counted in ``dcn_bwd.launches``."""
    with trace.kernel("kernel.dcn_bwd", x, weight, groups=deformable_groups):
        if x.device.type == "cpu":
            return dcn_bwd_om_plain(x, om, weight, g, deformable_groups,
                                    max_offset)
        return _launch_bwd(x, None, None, om, weight, g, deformable_groups,
                           max_offset)


dcn_bwd.launches = 0


def _bias_grad(g_pre, has_bias, dtype):
    return g_pre.float().sum((0, 1, 2)).to(dtype) if has_bias else None


class _DCN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, mask, weight, bias, dg, act, max_offset):
        out = dcn_fwd(x, offset, mask, weight, bias, dg, act, max_offset)
        ctx.save_for_backward(x, offset, mask, weight,
                              None if act is None else out)
        ctx.conf = (dg, act, max_offset, bias is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, offset, mask, weight, out = ctx.saved_tensors
        dg, act, max_offset, has_bias = ctx.conf
        g_pre = act_grad(g, out, act).contiguous()
        dx, doffset, dmask, dweight = dcn_bwd(x, offset, mask, weight, g_pre,
                                              dg, max_offset)
        return (dx, doffset, dmask, dweight,
                _bias_grad(g_pre, has_bias, g.dtype), None, None, None)


class _DCNOm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, om, weight, bias, dg, act, max_offset):
        out = dcn_fwd_om(x, om, weight, bias, dg, act, max_offset)
        ctx.save_for_backward(x, om, weight, None if act is None else out)
        ctx.conf = (dg, act, max_offset, bias is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        x, om, weight, out = ctx.saved_tensors
        dg, act, max_offset, has_bias = ctx.conf
        g_pre = act_grad(g, out, act).contiguous()
        dx, dom, dweight = dcn_bwd_om(x, om, weight, g_pre, dg, max_offset)
        return (dx, dom, dweight, _bias_grad(g_pre, has_bias, g.dtype), None,
                None, None)


def dcn_autograd(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                 weight: torch.Tensor, bias: torch.Tensor | None = None,
                 deformable_groups: int = 8, act: str | None = None,
                 max_offset: float | None = None) -> torch.Tensor:
    """Differentiable :func:`dcn_fwd`: forward :func:`dcn_fwd`, backward
    :func:`dcn_bwd` (the kernels for a CUDA tensor, their plain versions for
    a CPU tensor)."""
    return _DCN.apply(x, offset, mask, weight, bias, deformable_groups, act,
                      max_offset)


def dcn_om_autograd(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None,
                    deformable_groups: int = 8, act: str | None = None,
                    max_offset: float | None = None) -> torch.Tensor:
    """Differentiable :func:`dcn_fwd_om`: backward :func:`dcn_bwd_om`, so
    the gradient of ``om`` comes out whole."""
    return _DCNOm.apply(x, om, weight, bias, deformable_groups, act,
                        max_offset)
