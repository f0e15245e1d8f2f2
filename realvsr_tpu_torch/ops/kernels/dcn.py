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
with wgmma on tap t (the weight resident at 64 channels, streamed tap by
tap at 128); the backward takes one deformable group per block, sums dx in
a shared-memory footprint and folds dW into the same pass; see the sources.
Positions are exact f32: the TPU kernels' int16 fixed-point positions and
lane panels are not carried over.

The wrappers pick the kernel from the tensors' widths (``cin`` input and
``cout`` output channels, ``dg`` deformable groups, a mask or none;
:func:`route`), over the whole domain of the TPU kernel they replace:

* 64 -> 64 and 128 -> 128 in 8 groups with a mask: the wgmma pair
  ``dcn_fwd.cu`` / ``dcn_bwd.cu``;
* every other shape with dg dividing cin (16 in 4, the repo's debug
  configs; 64 -> 32, 96 in 4, 256 in 8, DCNv1 at any width, ...):
  ``dcn_narrow.cu``, a simple kernel each way (one pixel a thread, the tap
  products on the f32 cores, dx and dW summed with f32 atomics; the
  outputs tiled over the grid and the weight staged by tiles, taps or
  chunks where it outgrows shared memory), as the wgmma layouts (128-byte
  weight chunks, 8- or 16-channel dx footprints) do not fit;
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
(``*_plain``).  The autograd forms undo the fused activation and bias
before the backward kernel, as the JAX package adds the bias outside its
kernel and leaves its gradient to XLA.
"""
from __future__ import annotations

import ctypes
import math

import torch

from realvsr_tpu_torch.ops.deform_conv import (act_grad,
                                               modulated_deform_conv_plain,
                                               split_om)
from realvsr_tpu_torch.ops.kernels import _build

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
# x, off, off_stride, msk, msk_stride, logits, weight, bias, out, B, H, W,
# Ci, Co, G, act, max_off, clamp, stream; then the backward's, as dcn_bwd's
# without wt and rf and with Ci, Co, G in place of C
_NARROW_FUNCS = tuple(
    (f"dcn_narrow_fwd_{s}", (_P, _P, _I, _P, _I, _I, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _I, _F, _I, _P))
    for s in _build.SUFFIX.values()) + tuple(
    (f"dcn_narrow_bwd_{s}", (_P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P,
                             _I, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P))
    for s in _build.SUFFIX.values())
C, GROUPS, COUT = 64, 8, 64   # the flagship's width: channels, groups, outputs
WGMMA_WIDTHS = ((64, 8), (128, 8))  # dcn_fwd.cu / dcn_bwd.cu: C -> C, a mask
NARROW = (16, 4)              # the debug configs' width, on dcn_narrow.cu
NARROW_RUN = 256              # dcn_narrow.cu: kThreads, pixels of a block / run
NARROW_BLOCKS_PER_SM = 4      # dcn_narrow.cu: kBwdBlocksPerSm, at most
NARROW_CO = 16                # dcn_narrow.cu: kCo, a forward thread's sums
NARROW_FWD_BUDGET = 160 * 1024  # dcn_narrow.cu: kFwdBudget
NARROW_BWD_BUDGET = 160 * 1024  # dcn_narrow.cu: kBwdBudget
NARROW_CHUNK_CO = 32          # dcn_narrow.cu: kChunkCo
_SMEM_MAX, _SMEM_SM, _LINE = 232448, 228 * 1024, 128
# tile rows of both wgmma kernels at C = 64 (dcn_fwd.cu: Shape::TH,
# dcn_bwd.cu: Layout::TH), of 16 pixels (forward) or 32 (backward); each
# runs one block per SM, of 32 threads a row (:func:`tile_rows` at 128)
TILE_ROWS = {torch.bfloat16: 16, torch.float32: 8}
BWD_TW = 32                   # dcn_bwd.cu: kTW
RF_MAX = 8                    # dcn_bwd.cu: kRfMax


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


def _chunk_of(cpg: int) -> int:
    """``dcn_narrow.cu::chunk_of``: channels of a group read at once."""
    return 8 if cpg % 8 == 0 else 4 if cpg % 4 == 0 else \
        2 if cpg % 2 == 0 else 1


def narrow_fwd_plan(cin: int, cout: int) -> tuple[int, int]:
    """``dcn_narrow.cu::fwd_plan``: (outputs a block's tile, taps of the
    weight resident at once): all 9 taps of the widest tile of whole
    :data:`NARROW_CO`-output chunks within the forward budget, else 16
    outputs a tap at a time."""
    def smem(cot, ntap):
        return (ntap * cin * cot + cot) * 4
    cot = -(-cout // NARROW_CO) * NARROW_CO
    while cot > NARROW_CO and smem(cot, 9) > NARROW_FWD_BUDGET:
        cot -= NARROW_CO
    if smem(cot, 9) <= NARROW_FWD_BUDGET:
        return cot, 9
    return NARROW_CO, 1


def _chunk_ci(cin, cpg, ch, most):
    if cpg <= most:
        return min(most // cpg * cpg, cin)
    k = most // ch * ch
    while cpg % k:
        k -= ch
    return k


def _bwd_smem(kc, ko, one_co):
    return (kc * ko + NARROW_RUN * (ko + 1)
            + (1 if one_co else 2) * NARROW_RUN * (kc + 1)) * 4


def narrow_bwd_plan(cin: int, cout: int, dg: int) -> tuple[int, int, bool]:
    """``dcn_narrow.cu::bwd_plan``: (input channels a chunk, outputs a g
    chunk, whole-row form): the whole-row form (the run's g staged once,
    ``cout`` wide) with the widest chunk of cin, 64, 32, 16 or 8 input
    channels within the backward budget; else the chunked form (g and the
    weight in chunks of :data:`NARROW_CHUNK_CO` outputs)."""
    cpg = cin // dg
    ch = _chunk_of(cpg)
    for most in (cin, 64, 32, 16, 8):
        kc = _chunk_ci(cin, cpg, ch, most)
        if _bwd_smem(kc, cout, True) <= NARROW_BWD_BUDGET:
            return kc, cout, True
    return _chunk_ci(cin, cpg, ch, NARROW_CHUNK_CO), NARROW_CHUNK_CO, False


def tile_rows(dtype: torch.dtype, c: int = C, bwd: bool = False) -> int:
    """Tile rows of the wgmma pair at C channels (64 or 128): of the
    forward (``dcn_fwd.cu``: Shape::TH), or of the backward (``dcn_bwd.cu``:
    Layout::TH, 4 in both types at 128)."""
    if c == 128:
        return 4 if bwd else TILE_ROWS[dtype] // 2
    return TILE_ROWS[dtype]


def _es(dtype):
    return torch.tensor([], dtype=dtype).element_size()


def fwd_smem_bytes(dtype: torch.dtype, c: int = C, dg: int = GROUPS,
                   cout: int | None = None, has_mask: bool = True) -> int:
    """Shared memory of a forward block: ``dcn_fwd.cu::Shape::kSmem`` (the
    packed weight, resident at 64 channels and a ring of two taps at 128,
    and two A stages of a tile's pixels); on ``dcn_narrow.cu`` the f32
    weight of the block's output tile (its resident taps,
    :func:`narrow_fwd_plan`) and its bias."""
    cout = c if cout is None else cout
    if route(c, cout, dg, has_mask) == "narrow":
        cot, ntap = narrow_fwd_plan(c, cout)
        return (ntap * c * cot + cot) * 4
    chunks = c * _es(dtype) // _LINE
    weight = (9 if c == 64 else 2) * chunks * c * _LINE
    return weight + 2 * chunks * tile_rows(dtype, c) * 16 * _LINE


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
    """Shared memory of a backward block (``dcn_bwd.cu::smem_bytes``: the
    group's weight, resident at 64 channels and a ring of two taps at 128,
    the g tile, dS, two S buffers, the block reduction and the dx footprint
    of C / 8 + 1 ints a pixel); on ``dcn_narrow.cu`` (no footprint) one
    tap's f32 weight for a chunk of inputs and a run's g and S (and, in the
    chunked form, dS), rows padded by one (:func:`narrow_bwd_plan`)."""
    cout = c if cout is None else cout
    if route(c, cout, dg, has_mask) == "narrow":
        return _bwd_smem(*narrow_bwd_plan(c, cout, dg))
    es = _es(dtype)
    pad, cpg = 16 // es, c // GROUPS
    th = tile_rows(dtype, c, bwd=True)
    px = th * BWD_TW
    threads = px * cpg // 8
    fixed = ((9 if c == 64 else 2) * cpg * (c + pad) * es
             + px * (c + pad) * es + px * cpg * 4
             + 2 * cpg * (px + pad) * es + threads // 32 * 4)
    _, _, fh, fw = footprint(0, 0, rf, th)
    return fixed + fh * fw * (cpg + 1) * 4


def narrow_blocks_per_sm(c: int, cout: int | None = None,
                         dg: int = 1) -> int:
    """Backward blocks an SM of ``dcn_narrow.cu`` at ``c`` -> ``cout``
    channels in ``dg`` groups (``bwd_launch_form``'s per_sm): at most
    :data:`NARROW_BLOCKS_PER_SM`, as shared memory allows."""
    smem = _bwd_smem(*narrow_bwd_plan(c, c if cout is None else cout, dg))
    return min(NARROW_BLOCKS_PER_SM, _SMEM_SM // (smem + 1024))


def bwd_grid(b: int, h: int, w: int, sms: int, dtype: torch.dtype,
             c: int = C, dg: int = GROUPS, cout: int | None = None,
             has_mask: bool = True):
    """The backward's walk: for each block of its grid, (group, tiles); a
    tile is ``(b * tiles_y + ty) * tiles_x + tx`` (``dcn_bwd.cu``).  On
    ``dcn_narrow.cu`` a block takes every group (group None) and its tiles
    are runs of :data:`NARROW_RUN` consecutive pixels, run r the pixels
    ``[r * NARROW_RUN, (r + 1) * NARROW_RUN)``."""
    cout = c if cout is None else cout
    if route(c, cout, dg, has_mask) == "narrow":
        runs = -(-b * h * w // NARROW_RUN)
        blocks = min(runs, narrow_blocks_per_sm(c, cout, dg) * sms)
        return [(None, list(range(i, runs, blocks))) for i in range(blocks)]
    th = tile_rows(dtype, c, bwd=True)
    ntiles = b * -(-h // th) * -(-w // BWD_TW)
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
        weights, widths = (weight.data_ptr(),), (c, cout, dg)
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
    dtype, bf16 or f32 (on the wgmma pair f32 runs the tensor cores in
    TF32; on the narrow kernels the f32 cores).
    """
    if x.device.type == "cpu":
        return dcn_fwd_plain(x, offset, mask, weight, bias, deformable_groups,
                             act, max_offset)
    out = launch_fwd(x, offset, mask, weight, bias, deformable_groups, act,
                     max_offset)
    dcn_fwd.launches += 1
    return out


def dcn_fwd_om(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None = None, deformable_groups: int = 8,
               act: str | None = None,
               max_offset: float | None = None) -> torch.Tensor:
    """:func:`dcn_fwd` with the offsets and mask logits read in place from
    ``om`` (B, H, W, dg*27); counted in ``dcn_fwd.launches``."""
    if x.device.type == "cpu":
        return dcn_fwd_om_plain(x, om, weight, bias, deformable_groups, act,
                                max_offset)
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
        weights, widths, radius = (weight.data_ptr(),), (c, cout, dg), ()
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
    (the gate passes on [-R, R] inclusive).
    """
    if x.device.type == "cpu":
        return dcn_bwd_plain(x, offset, mask, weight, g, deformable_groups,
                             max_offset)
    return _launch_bwd(x, offset, mask, None, weight, g, deformable_groups,
                       max_offset)


def dcn_bwd_om(x: torch.Tensor, om: torch.Tensor, weight: torch.Tensor,
               g: torch.Tensor, deformable_groups: int = 8,
               max_offset: float | None = None):
    """:func:`dcn_bwd` from ``om``: (dx, dom, dweight), dom the gradient of
    ``om`` (B, H, W, dg*27) — the offset gradient as it is and the mask
    gradient times s (1 - s); counted in ``dcn_bwd.launches``."""
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
