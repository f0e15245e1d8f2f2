"""Kernels 3 and 4 of the TPU table: NHWC 3x3 conv with a fused epilogue on
Hopper (``csrc/conv3x3.cu``), at any number of output channels.

Replaces ``realvsr_tpu/ops/pallas/conv3x3_kernel.py::_packed_pallas``
(public ``conv3x3_packed``; its ``splits`` take PCD's concat inputs, here
the second input pointer ``x2`` does) and ``conv3x3_kernel.py::
conv3x3_fused`` (the same function at any output width, with the custom VJP
``conv3x3``).  Both run one CUDA kernel: persistent blocks, ``wgmma`` on
the whole output width (N = cout padded to one of :data:`WIDTHS`; past
256 outputs, column blocks of 256, :func:`column_blocks`), the weight
resident in shared memory or streamed tap by tap (up to 256 outputs on
128-byte chunks through a ring as deep as shared memory allows, and up
to 128 in clusters of two blocks, each slice read from L2 once a pair
and multicast to both: :func:`stream_plan`), the input halo loaded by
TMA in a ring of stages, and the epilogue (bias, activation, cast,
residual) in registers with 16-byte stores (streamed weights: by TMA
stores); see the source for the design.  No pair packing: the TPU's
128-lane layout is not carried over.

The weight goes to the kernel as the image of its shared memory, which a
small kernel of the same source lays out before each launch
(:func:`pack_weight_cuda`; :func:`pack_weight` is its plain version): per
column block (one up to 256 outputs), chunk of input channels and tap, N
rows of that chunk, with the swizzle of the ``wgmma`` descriptors, in TF32
for f32 (:func:`round_tf32`).  A chunk is 128 bytes (64 bf16 or 32 f32
channels) where both inputs are whole chunks, else 32 bytes (16 / 8: the
narrow inputs of the nf 16 debug configs, 16, 32 and 48 wide;
:func:`chunk_bytes`).  Narrow inputs whose weight fits shared memory
(:func:`weight_resident`: every debug conv) skip the packer: the conv's
blocks lay the OIHW weight out themselves, so a call is one launch.
:func:`conv3x3_from_packed` computes the conv from that image tap by tap
in the kernel's order; the CPU tests hold it against the plain conv and
the JAX kernel.

:func:`conv3x3` launches the kernel for a CUDA tensor; a launch with 64
output channels counts in ``conv3x3.launches``, one with any other width in
``conv3x3_fused.launches``, so the two rows of the TPU table keep their own
counts; of these, the launches on 32-byte chunks (narrow inputs) count in
``conv3x3_narrow.launches`` too.  For a CPU tensor it runs
:func:`conv3x3_plain`.  Either way a call is one ``kernel.conv3x3`` span
(``utils/trace.py``), and each of the backward's cuDNN calls one
``kernel.conv3x3_bwd``.
:func:`conv3x3_fused` is the JAX-named entry (one input, no ``x2``).
:func:`conv3x3_autograd` is the differentiable op (the counterpart of the
JAX custom VJP ``conv3x3``): the kernel forward, and a backward through
cuDNN's data and weight gradients in the activation dtype, as the JAX
package's custom VJPs (``conv3x3_kernel.py::conv3x3``, ``_packed_core_bwd``)
leave their backward to stock XLA.  Unlike those it does not recompute the
forward: the activation's slope comes from the kernel's own output (as the
DCN's backward does), so the gradient follows the forward's decisions — a
bf16 recompute rounds the conv before the bias and flips the sign of some
pre-activations near 0.
"""
from __future__ import annotations

import ctypes
import functools
from types import SimpleNamespace
from typing import NamedTuple

import torch
import torch.nn.functional as F

from realvsr_tpu_torch.csrc.gen_wgmma import WIDTHS
from realvsr_tpu_torch.ops.deform_conv import act_grad, apply_act
from realvsr_tpu_torch.ops.kernels import _build
from realvsr_tpu_torch.utils import trace

_P, _I = ctypes.c_void_p, ctypes.c_int
# x1, c1, x2, c2, weight, packed, bias, residual, out, B, H, W, cout, n,
# act, stream; the packer's weight, packed, cout, cin, n, chunk bytes,
# stream
_FUNCS = tuple((f"conv3x3_{s}", (_P, _I, _P, _I, _P, _P, _P, _P, _P, _I, _I,
                                 _I, _I, _I, _I, _P))
               for s in _build.SUFFIX.values()) \
    + tuple((f"conv3x3_pack_{s}", (_P, _P, _I, _I, _I, _I, _P))
            for s in _build.SUFFIX.values())
_COUT = 64         # the outputs counted in conv3x3.launches
LRELU_SLOPE = 0.1  # the kernel's only LeakyReLU slope, the repo's only one
LINE = 128         # bytes of one channel chunk: a row of the swizzle
NARROW_LINE = 32   # the chunk of narrow inputs: one wgmma k-step
# conv3x3.cu's shared memory: a block's most, the halo window, a warp's
# epilogue rows and padding, the mbarriers (plan())
_SMEM_MAX, _HALO_PIXELS, _EPI_ROWS, _EPI_PAD, _BARS = (232448, 10 * 18, 16,
                                                       8, 8 * 15)
# its streamed regime (kPair, kPairHalo, kRingMax, kRingSplit, kPairWidth,
# kEpiBufs): blocks a cluster, halo stages, most weight slots, the slots of
# the cluster kernel's ring beside its resident slices, the widest N in
# clusters, the epilogue's staging buffers a warp
PAIR, PAIR_HALO, RING_MAX, RING_SPLIT, PAIR_WIDTH, EPI_BUFS = (2, 2, 16, 6,
                                                               128, 2)
# kTmaOutWidth: past PAIR_WIDTH, the TMA-store epilogue (bf16 only)
TMA_OUT_WIDTH = 216


def conv3x3_plain(x, weight, bias=None, act=None, residual=None, x2=None):
    """The kernel's function in plain PyTorch: conv in f32 (f64 for a
    float64 input), + bias, act, cast to the input type, + residual (in the
    input type)."""
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    ct = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(xin.permute(0, 3, 1, 2).to(ct), weight.to(ct),
                 None if bias is None else bias.to(ct), padding=1)
    y = apply_act(y, act).permute(0, 2, 3, 1).to(x.dtype)
    if residual is not None:
        y = y + residual
    return y.contiguous()


def chunk(dtype: torch.dtype, line: int = LINE) -> int:
    """Input channels in one chunk of ``line`` bytes: 64 bf16 / 32 f32 in
    128 bytes, 16 / 8 in 32."""
    return line // dtype.itemsize


def chunk_bytes(c1: int, c2: int, dtype: torch.dtype) -> int:
    """The kernel's input chunk for these widths: 128 bytes where both are
    whole 128-byte chunks (every conv of the nf 64 / 128 models), else 32
    (:data:`NARROW_LINE`: the nf 16 debug configs' 16- and 32-wide inputs,
    48); c1 and c2 are multiples of 16."""
    ch = chunk(dtype)
    return LINE if c1 % ch == 0 and c2 % ch == 0 else NARROW_LINE


def kernel_width(cout: int) -> int:
    """N of the kernel's ``wgmma``: the smallest of :data:`WIDTHS` that
    holds cout."""
    for n in WIDTHS:
        if n >= cout:
            return n
    raise ValueError(f"conv3x3: no wgmma width for {cout} outputs")


def column_blocks(cout: int) -> list[tuple[int, int]]:
    """The wgmma kernel's column blocks, (first output, N): one of
    :func:`kernel_width` up to 256 outputs; past that, blocks of 256 with
    the last padded to the width that holds its rest (300 = 256 + 64)."""
    full = WIDTHS[-1]
    if cout <= full:
        return [(0, kernel_width(cout))]
    return [(c0, full if cout - c0 >= full else kernel_width(cout - c0))
            for c0 in range(0, cout, full)]


def weight_resident(c1: int, c2: int, cout: int, dtype: torch.dtype) -> bool:
    """Whether the kernel keeps the whole weight in shared memory beside two
    halo stages and the epilogue's rows (``conv3x3.cu::plan``), or streams
    it tap by tap.  Narrow inputs with a resident weight run one launch:
    their blocks lay it out, and no packer runs."""
    blocks = column_blocks(cout)
    if len(blocks) > 1:
        return False
    es = dtype.itemsize
    halo = -(-_HALO_PIXELS * chunk_bytes(c1, c2, dtype) // 1024) * 1024
    epi = 8 * _EPI_ROWS * (LINE // es + _EPI_PAD) * es
    return ((c1 + c2) * es * 9 * blocks[0][1] + 2 * halo + epi + _BARS
            <= _SMEM_MAX)


class StreamPlan(NamedTuple):
    """A conv of the streamed regime (``conv3x3.cu::plan_stream``, design
    note 7): the halo stages and weight slots of its ring, whether it runs
    in clusters of :data:`PAIR` blocks, each weight slice multicast to both
    (N up to :data:`PAIR_WIDTH`), and the slices of a tile's weight that
    the cluster kernel keeps resident beside a ring of :data:`RING_SPLIT`
    (the first of each tile; the rest streamed)."""
    stages: int
    slots: int
    pair: bool
    resident: int


@functools.lru_cache(maxsize=None)
def stream_plan(c1: int, c2: int, cout: int, dtype: torch.dtype,
                residual: bool = False) -> StreamPlan | None:
    """The streamed regime's plan for a conv that takes it: one whose
    weight is not resident, on 128-byte chunks, at most 256 outputs; None
    for any other.  Its epilogue stages the TMA stores (in clusters, and
    at :data:`TMA_OUT_WIDTH` in bf16 without a residual, rows of whole
    16-byte vectors) or runs the resident convs' (the rest), which takes
    less shared memory."""
    blocks = column_blocks(cout)
    if (len(blocks) > 1 or chunk_bytes(c1, c2, dtype) != LINE
            or weight_resident(c1, c2, cout, dtype)):
        return None
    n, es = blocks[0][1], dtype.itemsize
    stage = -(-_HALO_PIXELS * LINE // 1024) * 1024
    tma = n <= PAIR_WIDTH or (n == TMA_OUT_WIDTH and es == 2
                              and not residual and cout * es % 16 == 0)
    epi = (8 * EPI_BUFS * _EPI_ROWS * LINE if tma
           else 8 * _EPI_ROWS * (LINE // es + _EPI_PAD) * es)
    bars = 8 * (2 * PAIR_HALO + 2 * RING_MAX + 1)
    slots = (_SMEM_MAX - PAIR_HALO * stage - epi - bars) // (n * LINE)
    pair, res = n <= PAIR_WIDTH, 0
    if pair and slots > RING_SPLIT:
        res = min(slots - RING_SPLIT, 9 * (c1 + c2) // chunk(dtype) - 1)
        slots = RING_SPLIT
    return StreamPlan(PAIR_HALO, min(slots, RING_MAX), pair, res)


def _units(ch: int) -> int:
    """16-byte units in a chunk row of ``ch`` channels: 8 in the 128-byte
    chunks (64 bf16 / 32 f32), 2 in the 32-byte ones (16 / 8)."""
    return 8 if ch >= 32 else 2


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """The swizzle on (..., rows, units, e) with 8 or 2 units of 16 bytes a
    row (128- or 32-byte rows): unit j of row r moves to j ^ (r % 8), or to
    j ^ ((r // 4) % 2).  Its own inverse."""
    units = t.shape[-2]
    r = torch.arange(8).view(8, 1)   # the pattern repeats every 8 rows
    shift = r if units == 8 else r // 4
    lead = t.shape[:-3]
    t = t.reshape(*lead, t.shape[-3] // 8, 8, units, t.shape[-1])
    return t[..., r, shift ^ torch.arange(units), :].reshape(
        *lead, -1, units, t.shape[-1])


def pack_weight(weight: torch.Tensor, n: int, ch: int) -> torch.Tensor:
    """The kernel's shared-memory image of an OIHW weight (cout, cin, 3, 3):
    (ceil(cout / n), cin / ch, 9, n, ch) — column block of ``n`` outputs
    (one where cout <= n), chunk of ``ch`` input channels (64 / 32 in a
    128-byte chunk, 16 / 8 in a 32-byte one), tap (dy * 3 + dx), output row
    of the block (zeros past cout), channel — with the 16-byte units of each
    row swizzled (:func:`_swizzle`), flattened.  Any dtype (the tests pack
    indices with it)."""
    cout, cin = weight.shape[:2]
    ncb, u = -(-cout // n), _units(ch)
    w = weight.permute(2, 3, 0, 1).reshape(9, cout, cin // ch, ch)
    w = torch.cat([w, w.new_zeros(9, ncb * n - cout, cin // ch, ch)], 1)
    w = w.reshape(9, ncb, n, cin // ch, ch).permute(1, 3, 0, 2, 4)
    return _swizzle(w.reshape(ncb, cin // ch, 9, n, u, ch // u)).reshape(-1)


def unpack_weight(packed: torch.Tensor, cout: int, cin: int, n: int,
                  ch: int) -> torch.Tensor:
    """(cin / ch, 9, cout, ch) from :func:`pack_weight`'s image with
    column blocks of ``n``."""
    ncb, u = packed.numel() // (cin * 9 * n), _units(ch)
    w = _swizzle(packed.reshape(ncb, cin // ch, 9, n, u, ch // u))
    w = w.reshape(ncb, cin // ch, 9, n, ch).permute(1, 2, 0, 3, 4)
    return w.reshape(cin // ch, 9, ncb * n, ch)[:, :, :cout]


def conv3x3_from_packed(x, packed, cout, bias=None, act=None, residual=None,
                        x2=None, ch=None):
    """:func:`conv3x3_plain` from the packed weight (packed with ``ch``
    channels a chunk, by default the kernel's for these input widths and
    x's dtype, and column blocks of 256 past 256 outputs), in the kernel's
    order: per column block, per input chunk, per tap, the shifted input
    times that tap's weight, summed in f32; then bias, act, cast,
    residual."""
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    b, h, w, cin = xin.shape
    ch = ch or chunk(x.dtype, chunk_bytes(x.shape[-1], cin - x.shape[-1],
                                          x.dtype))
    n = min(packed.numel() // (9 * cin), WIDTHS[-1])
    wk = unpack_weight(packed, cout, cin, n, ch).float()
    xp = F.pad(xin.float(), (0, 0, 1, 1, 1, 1))
    y = xin.new_zeros(b, h, w, cout, dtype=torch.float32)
    for c0 in range(0, cout, n):
        for c in range(cin // ch):
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                xs = xp[:, dy:dy + h, dx:dx + w, c * ch:(c + 1) * ch]
                y[..., c0:c0 + n] += xs @ wk[c, tap, c0:c0 + n].t()
    if bias is not None:
        y = y + bias.float()
    y = apply_act(y, act).to(x.dtype)
    if residual is not None:
        y = y + residual
    return y


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10-bit mantissa), to nearest with ties away from
    0, as ``cvt.rna.tf32.f32`` rounds the kernel's other operand."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def pack_weight_cuda(weight: torch.Tensor, n: int,
                     line: int = LINE) -> torch.Tensor:
    """:func:`pack_weight` of a CUDA weight by the kernel's own packer, in
    chunks of ``line`` bytes (128 or 32), with f32 rounded to TF32
    (:func:`round_tf32`)."""
    cout, cin = weight.shape[:2]
    packed = torch.empty(-(-cout // n) * cin * 9 * n, device=weight.device,
                         dtype=weight.dtype)
    lib = _build.load("conv3x3", _FUNCS)
    with torch.cuda.device(weight.device):
        code = getattr(lib, f"conv3x3_pack_{_build.SUFFIX[weight.dtype]}")(
            weight.data_ptr(), packed.data_ptr(), cout, cin, n, line,
            torch.cuda.current_stream(weight.device).cuda_stream)
    _build.check(code, "conv3x3_pack")
    return packed


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None, act: str | None = None,
            residual: torch.Tensor | None = None,
            x2: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 / stride 1 / SAME conv of NHWC ``x`` (channel-concatenated with
    ``x2`` when given), + bias, act None / "relu" / "lrelu", cast, +
    ``residual`` (added after the activation).

    x: (B, H, W, c1); x2: (B, H, W, c2) or None; weight (cout, c1 + c2, 3,
    3), any cout >= 1; bias (cout,) or None; residual (B, H, W, cout) or
    None.  All contiguous and 16-byte aligned, of one dtype, bf16 or f32
    (f32 runs the tensor cores in TF32); c1 and c2 multiples of 16.
    Traced as one ``kernel.conv3x3`` span a call
    (:func:`realvsr_tpu_torch.utils.trace.kernel`).
    """
    with trace.kernel("kernel.conv3x3", x, weight, x2, act=act):
        return _conv3x3(x, weight, bias, act, residual, x2)


def _conv3x3(x, weight, bias, act, residual, x2):
    """:func:`conv3x3` inside its span (it calls itself under the tensor's
    device, which opens no second span)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, act, residual, x2)
    if not x.is_cuda:
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    if x.dtype not in _build.SUFFIX:
        raise ValueError(f"conv3x3: dtype {x.dtype} not supported")
    if act not in _build.ACTS:
        raise ValueError(f"conv3x3: unknown activation {act!r}")
    if x.dim() != 4:
        raise ValueError("conv3x3: x must be (B, H, W, C)")
    b, h, w, c1 = x.shape
    c2 = 0 if x2 is None else x2.shape[-1]
    if c1 % 16 or c2 % 16:
        raise ValueError(f"conv3x3: input channels {c1}+{c2} must be "
                         "multiples of 16")
    cout = weight.shape[0]
    if cout < 1:
        raise ValueError("conv3x3: no output channels")
    dt, dev = x.dtype, x.device
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _conv3x3(x, weight, bias, act, residual, x2)
    _build.check_tensor(x, "x", (b, h, w, c1), dt, dev)
    if x2 is not None:
        _build.check_tensor(x2, "x2", (b, h, w, c2), dt, dev)
    _build.check_tensor(weight, "weight", (cout, c1 + c2, 3, 3), dt, dev)
    if bias is not None:
        _build.check_tensor(bias, "bias", (cout,), dt, dev)
    if residual is not None:
        _build.check_tensor(residual, "residual", (b, h, w, cout), dt, dev)
    fn, n, narrow, scratch = _plan(c1, c2, cout, dt)
    packed = None if scratch == 0 else torch.empty(scratch, device=dev,
                                                   dtype=dt)
    out = torch.empty(b, h, w, cout, device=dev, dtype=dt)
    code = fn(x.data_ptr(), c1, None if x2 is None else x2.data_ptr(), c2,
              weight.data_ptr(), None if packed is None else packed.data_ptr(),
              None if bias is None else bias.data_ptr(),
              None if residual is None else residual.data_ptr(),
              out.data_ptr(), b, h, w, cout, n, _build.ACTS[act],
              _build.raw_stream(dev))
    _build.check(code, "conv3x3")
    if cout == _COUT:
        conv3x3.launches += 1
    else:
        conv3x3_fused.launches += 1
    if narrow:
        conv3x3_narrow.launches += 1
    return out


def scratch_elements(c1: int, c2: int, cout: int, dtype: torch.dtype) -> int:
    """Elements of the scratch the kernel's packer lays the weight out in:
    every column block (:func:`column_blocks`) of (c1 + c2) * 9 rows; none
    for narrow inputs whose weight is resident (their blocks lay it out)."""
    if (chunk_bytes(c1, c2, dtype) == NARROW_LINE
            and weight_resident(c1, c2, cout, dtype)):
        return 0
    blocks = column_blocks(cout)
    return len(blocks) * (c1 + c2) * 9 * blocks[0][1]


@functools.lru_cache(maxsize=None)
def _plan(c1: int, c2: int, cout: int, dtype: torch.dtype):
    """(the C entry, n: the last (or only) column block's width, narrow
    inputs, elements of scratch the packer lays the weight out in), once a
    width and dtype: at the nf 16 debug configs' sizes a call's host time
    is its cost."""
    fn = getattr(_build.load("conv3x3", _FUNCS),
                 f"conv3x3_{_build.SUFFIX[dtype]}")
    return (fn, column_blocks(cout)[-1][1],
            chunk_bytes(c1, c2, dtype) == NARROW_LINE,
            scratch_elements(c1, c2, cout, dtype))


conv3x3.launches = 0


# the count of conv3x3's launches on 32-byte chunks, the narrow inputs
# (each counts in conv3x3 or conv3x3_fused as well)
conv3x3_narrow = SimpleNamespace(launches=0)


def conv3x3_fused(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor | None = None, act: str | None = None,
                  residual: torch.Tensor | None = None, *,
                  alpha: float = LRELU_SLOPE) -> torch.Tensor:
    """The JAX ``conv3x3_fused``: :func:`conv3x3` of one NHWC input at any
    output width (weight OIHW, as the port's modules hold it).  ``alpha`` is
    the LeakyReLU slope; the kernel has only 0.1, the one slope the repo
    uses, and any other raises."""
    if alpha != LRELU_SLOPE:
        raise ValueError(f"conv3x3_fused: lrelu slope {alpha}; the kernel "
                         f"has {LRELU_SLOPE} only")
    return conv3x3(x, weight, bias, act, residual)


conv3x3_fused.launches = 0


def _grad_conv(x, weight, g_nchw, bias):
    """(d input, d weight, d bias or None) of a 3x3 / s1 / p1 conv of NHWC
    ``x`` for the NCHW cotangent ``g_nchw``, in the input dtype: one
    ``convolution_backward`` with the real weight, as ``F.conv2d``'s own
    autograd calls it (cuDNN on the card); a ``kernel.conv3x3_bwd`` span."""
    with trace.kernel("kernel.conv3x3_bwd", x, weight):
        dx, dw, db = torch.ops.aten.convolution_backward(
            g_nchw, x.permute(0, 3, 1, 2), weight.contiguous(),
            [weight.shape[0]] if bias else None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1, [True, True, bias])
    return dx.permute(0, 2, 3, 1), dw, db


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, residual, x2, act):
        out = conv3x3(x, weight, bias, act, residual, x2)
        ctx.save_for_backward(x, weight, x2, None if act is None else out)
        ctx.act = act
        ctx.has_bias = bias is not None
        ctx.has_residual = residual is not None
        return out

    @staticmethod
    def backward(ctx, g):
        x, weight, x2, out = ctx.saved_tensors
        g_pre = act_grad(g, out, ctx.act)
        gn = g_pre.permute(0, 3, 1, 2)
        c1 = x.shape[-1]
        dx, dweight, dbias = _grad_conv(x, weight[:, :c1], gn, ctx.has_bias)
        dx2 = None
        if x2 is not None:
            dx2, dw2, _ = _grad_conv(x2, weight[:, c1:], gn, False)
            dweight = torch.cat([dweight, dw2], dim=1)
        return (dx, dweight, dbias, g if ctx.has_residual else None, dx2,
                None)


def conv3x3_autograd(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor | None = None, act: str | None = None,
                     residual: torch.Tensor | None = None,
                     x2: torch.Tensor | None = None) -> torch.Tensor:
    """Differentiable :func:`conv3x3` (the kernel for a CUDA tensor, its
    plain version for a CPU tensor), with a backward through the conv's data
    and weight gradients (cuDNN on the card).  The backward takes the
    activation's slope from the forward's output, so an activation and a
    residual (added after it) do not go together here.  With gradients off
    (inference) it is :func:`conv3x3` itself: an autograd function's call
    costs the host ~10-25 us, a third of a small conv's."""
    if act is not None and residual is not None:
        raise ValueError("conv3x3_autograd: an activation with a residual "
                         "is not differentiable here")
    if not torch.is_grad_enabled():
        return conv3x3(x, weight, bias, act, residual, x2)
    return _Conv3x3.apply(x, weight, bias, residual, x2, act)
