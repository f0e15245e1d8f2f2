"""Kernels 3 and 4 of the TPU table: NHWC 3x3 conv with a fused epilogue on
Hopper (``csrc/conv3x3.cu``), at any number of output channels.

Replaces ``realvsr_tpu/ops/pallas/conv3x3_kernel.py::_packed_pallas``
(public ``conv3x3_packed``; its ``splits`` take PCD's concat inputs, here
the second input pointer ``x2`` does) and ``conv3x3_kernel.py::
conv3x3_fused`` (the same function at any output width, with the custom VJP
``conv3x3``).  Both run one CUDA kernel: persistent blocks, ``wgmma`` on
the whole output width (N = cout padded to one of :data:`WIDTHS`), the
weight resident in shared memory or streamed tap by tap, the input halo
loaded by TMA in a ring of stages, and the epilogue (bias, activation,
cast, residual) in registers with 16-byte stores; see the source for the
design.  No pair packing: the TPU's 128-lane layout is not carried over.

The weight goes to the kernel as the image of its shared memory, which a
small kernel of the same source lays out before each launch
(:func:`pack_weight_cuda`; :func:`pack_weight` is its plain version): per
128-byte chunk of input channels (64 bf16 or 32 f32) and tap, N rows of
that chunk, with the 128-byte swizzle of the ``wgmma`` descriptors, in
TF32 for f32 (:func:`round_tf32`).  :func:`conv3x3_from_packed` computes
the conv from that image tap by tap in the kernel's order; the CPU tests
hold it against the plain conv and the JAX kernel.

Inputs whose widths are not whole chunks (c1 or c2 of 16 or 48), and cout
above 256, run the ``mma.sync`` kernel of ``csrc/conv3x3_sync.cu`` instead,
chosen here by shape (:func:`uses_wgmma`); no conv of the model paths does.

:func:`conv3x3` launches a kernel for a CUDA tensor; a launch with 64
output channels counts in ``conv3x3.launches``, one with any other width in
``conv3x3_fused.launches``, so the two rows of the TPU table keep their own
counts.  For a CPU tensor it runs :func:`conv3x3_plain`.
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

import torch
import torch.nn.functional as F

from realvsr_tpu_torch.csrc.gen_wgmma import WIDTHS
from realvsr_tpu_torch.ops.deform_conv import act_grad, apply_act
from realvsr_tpu_torch.ops.kernels import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = (_P, _I, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)
_FUNCS = tuple((f"conv3x3_{s}", _ARGS[:5] + (_P,) + _ARGS[5:])
               for s in _build.SUFFIX.values()) \
    + tuple((f"conv3x3_pack_{s}", (_P, _P, _I, _I, _I, _P))
            for s in _build.SUFFIX.values())
_SYNC_FUNCS = tuple((f"conv3x3_sync_{s}", _ARGS)
                    for s in _build.SUFFIX.values())
_HALO, _COUT, _SMEM_MAX = (4 + 2) * (32 + 2), 64, 232448  # mma.sync kernel
LRELU_SLOPE = 0.1  # the kernel's only LeakyReLU slope, the repo's only one
LINE = 128         # bytes of one channel chunk: a row of the swizzle


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


def chunk(dtype: torch.dtype) -> int:
    """Input channels in one 128-byte chunk: 64 bf16, 32 f32."""
    return LINE // dtype.itemsize


def kernel_width(cout: int) -> int:
    """N of the kernel's ``wgmma``: the smallest of :data:`WIDTHS` that
    holds cout."""
    for n in WIDTHS:
        if n >= cout:
            return n
    raise ValueError(f"conv3x3: no wgmma width for {cout} outputs")


def uses_wgmma(c1: int, c2: int, cout: int, dtype: torch.dtype) -> bool:
    """Whether the wgmma kernel takes these widths (else the mma.sync one):
    whole 128-byte input chunks and at most 256 outputs."""
    ch = chunk(dtype)
    return c1 % ch == 0 and c2 % ch == 0 and cout <= WIDTHS[-1]


def _swizzle(t: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle on (..., rows, 8 units of 16 bytes, e): unit j
    of row r moves to unit j ^ (r % 8).  Its own inverse."""
    r = torch.arange(8).view(8, 1)
    lead = t.shape[:-3]
    t = t.reshape(*lead, t.shape[-3] // 8, 8, 8, t.shape[-1])
    return t[..., r, r ^ torch.arange(8), :].reshape(*lead, -1, 8,
                                                     t.shape[-1])


def pack_weight(weight: torch.Tensor, n: int, ch: int) -> torch.Tensor:
    """The kernel's shared-memory image of an OIHW weight (cout, cin, 3, 3):
    (cin / ch, 9, n, ch) — chunk of ``ch`` input channels, tap (dy * 3 +
    dx), output row (zeros from cout to n), channel — with each 8-row group
    of 128-byte rows swizzled (:func:`_swizzle`), flattened.  Any dtype
    (the tests pack indices with it)."""
    cout, cin = weight.shape[:2]
    w = weight.permute(2, 3, 0, 1).reshape(9, cout, cin // ch, ch)
    w = torch.cat([w, w.new_zeros(9, n - cout, cin // ch, ch)], 1)
    w = w.permute(2, 0, 1, 3).reshape(cin // ch, 9, n, 8, ch // 8)
    return _swizzle(w).reshape(-1)


def unpack_weight(packed: torch.Tensor, cout: int, cin: int, n: int,
                  ch: int) -> torch.Tensor:
    """(cin / ch, 9, cout, ch) from :func:`pack_weight`'s image."""
    w = _swizzle(packed.reshape(cin // ch, 9, n, 8, ch // 8))
    return w.reshape(cin // ch, 9, n, ch)[:, :, :cout]


def conv3x3_from_packed(x, packed, cout, bias=None, act=None, residual=None,
                        x2=None, ch=None):
    """:func:`conv3x3_plain` from the packed weight (packed with ``ch``
    channels a chunk, by default the kernel's for x's dtype), in the
    kernel's order: per input chunk, per tap, the shifted input times that
    tap's weight, summed in f32; then bias, act, cast, residual."""
    xin = x if x2 is None else torch.cat([x, x2], dim=-1)
    b, h, w, cin = xin.shape
    ch = ch or chunk(x.dtype)
    n = packed.numel() // (9 * cin)
    wk = unpack_weight(packed, cout, cin, n, ch).float()
    xp = F.pad(xin.float(), (0, 0, 1, 1, 1, 1))
    y = xin.new_zeros(b, h, w, cout, dtype=torch.float32)
    for c in range(cin // ch):
        for tap in range(9):
            dy, dx = divmod(tap, 3)
            xs = xp[:, dy:dy + h, dx:dx + w, c * ch:(c + 1) * ch]
            y = y + xs @ wk[c, tap].t()
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


def pack_weight_cuda(weight: torch.Tensor, n: int) -> torch.Tensor:
    """:func:`pack_weight` of a CUDA weight by the kernel's own packer,
    with f32 rounded to TF32 (:func:`round_tf32`)."""
    cout, cin = weight.shape[:2]
    packed = torch.empty(cin * 9 * n, device=weight.device,
                         dtype=weight.dtype)
    lib = _build.load("conv3x3", _FUNCS)
    with torch.cuda.device(weight.device):
        code = getattr(lib, f"conv3x3_pack_{_build.SUFFIX[weight.dtype]}")(
            weight.data_ptr(), packed.data_ptr(), cout, cin, n,
            torch.cuda.current_stream(weight.device).cuda_stream)
    _build.check(code, "conv3x3_pack")
    return packed


def _tile_cols(cout: int) -> int:
    """Output columns of the mma.sync kernel's channel tile: 64 (8 mma
    n-tiles) from cout = 33 up, else the fewest of 8, 16 or 32 that cover
    cout."""
    return 64 if cout > 32 else 32 if cout > 16 else 16 if cout > 8 else 8


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            bias: torch.Tensor | None = None, act: str | None = None,
            residual: torch.Tensor | None = None,
            x2: torch.Tensor | None = None) -> torch.Tensor:
    """3x3 / stride 1 / SAME conv of NHWC ``x`` (channel-concatenated with
    ``x2`` when given), + bias, act None / "relu" / "lrelu", cast, +
    ``residual`` (added after the activation).

    x: (B, H, W, c1); x2: (B, H, W, c2) or None; weight (cout, c1 + c2, 3,
    3), any cout >= 1; bias (cout,) or None; residual (B, H, W, cout) or
    None.  All contiguous, of one dtype, bf16 or f32 (f32 runs the tensor
    cores in TF32); c1 and c2 multiples of 16.
    """
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
    wgmma = uses_wgmma(c1, c2, cout, dt)
    if not wgmma:
        pad, tile = 16 // x.element_size(), _tile_cols(cout)
        if (_HALO + tile) * (c1 + c2 + pad) * x.element_size() > _SMEM_MAX:
            raise ValueError(f"conv3x3: {c1 + c2} input channels exceed "
                             "shared memory")
    _build.check_tensor(x, "x", (b, h, w, c1), dt, dev)
    if x2 is not None:
        _build.check_tensor(x2, "x2", (b, h, w, c2), dt, dev)
    _build.check_tensor(weight, "weight", (cout, c1 + c2, 3, 3), dt, dev)
    if bias is not None:
        _build.check_tensor(bias, "bias", (cout,), dt, dev)
    if residual is not None:
        _build.check_tensor(residual, "residual", (b, h, w, cout), dt, dev)
    if wgmma:  # the weight and the scratch its packer lays it out in
        n = kernel_width(cout)
        wk = (weight, torch.empty((c1 + c2) * 9 * n, device=dev, dtype=dt))
        lib, name = _build.load("conv3x3", _FUNCS), "conv3x3"
    else:   # (cout, tap, cin), zero rows up to whole channel tiles
        n = _tile_cols(cout)
        wt = weight.permute(0, 2, 3, 1)
        if cout % n:
            wt = torch.cat([wt, wt.new_zeros(n - cout % n, 3, 3, c1 + c2)])
        wk = (wt.contiguous(),)
        lib, name = _build.load("conv3x3_sync", _SYNC_FUNCS), "conv3x3_sync"
    out = torch.empty(b, h, w, cout, device=dev, dtype=dt)
    with torch.cuda.device(dev):
        code = getattr(lib, f"{name}_{_build.SUFFIX[dt]}")(
            x.data_ptr(), c1, None if x2 is None else x2.data_ptr(), c2,
            *(t.data_ptr() for t in wk),
            None if bias is None else bias.data_ptr(),
            None if residual is None else residual.data_ptr(), out.data_ptr(),
            b, h, w, cout, n, _build.ACTS[act],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, name)
    if cout == _COUT:
        conv3x3.launches += 1
    else:
        conv3x3_fused.launches += 1
    return out


conv3x3.launches = 0


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
    autograd calls it (cuDNN on the card)."""
    dx, dw, db = torch.ops.aten.convolution_backward(
        g_nchw, x.permute(0, 3, 1, 2), weight.contiguous(),
        [weight.shape[0]] if bias else None, [1, 1], [1, 1], [1, 1], False,
        [0, 0], 1, [True, True, bias])
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
    residual (added after it) do not go together here."""
    if act is not None and residual is not None:
        raise ValueError("conv3x3_autograd: an activation with a residual "
                         "is not differentiable here")
    return _Conv3x3.apply(x, weight, bias, residual, x2, act)
