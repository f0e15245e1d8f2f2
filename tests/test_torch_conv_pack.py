"""The conv3x3 kernel's weight layout, on the CPU.

The kernel (``realvsr_tpu_torch/csrc/conv3x3.cu``) reads the weight as the
image of its shared memory that ``ops/kernels/conv3x3.py::pack_weight``
makes, in 128-byte input chunks or, for narrow inputs (16, 32 or 48 wide:
the nf 16 debug configs), 32-byte ones; the kernel itself, its packer, its
in-kernel layout of a narrow weight and its walk over the output tiles
(ragged, across images) run only on the card (``tests/test_torch_cuda.py``).
Here, with inputs from numpy seeds in f32:

* ``conv3x3_from_packed`` (the conv from the packed weight, column block
  by column block, chunk by chunk and tap by tap in the kernel's order)
  against ``conv3x3_plain`` and against the JAX ``conv3x3_fused`` in
  interpret mode, at cout 3, 64, 216, 256 and, in column blocks of 256,
  300 (256 + 64) and 512 (256 + 256), one input of 64 and two of 64 + 64,
  ragged H x W; on 32-byte chunks at 16 and 48 inputs and 16 + 16;
  tolerance 5e-5: the same f32 products summed in another order;
* the packed image element by element against the layout stated in the
  kernel's source, 512 outputs in two column blocks and 32-byte chunks
  among the cases (the kernel's own packer is held to it on the card);
* which chunk the wrapper chooses for which widths, where the weight is
  resident, the TF32 rounding of the f32 weight, and that the written-out
  wgmma header is up to date.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.ops.pallas.conv3x3_kernel import (
    conv3x3_fused as jax_conv3x3_fused)
from realvsr_tpu_torch.csrc import gen_wgmma
from realvsr_tpu_torch.ops.kernels import _build
from realvsr_tpu_torch.ops.kernels import conv3x3 as conv_mod
from realvsr_tpu_torch.ops.kernels.conv3x3 import (
    LINE, NARROW_LINE, WIDTHS, chunk, chunk_bytes, column_blocks,
    conv3x3_from_packed, conv3x3_plain, kernel_width, pack_weight,
    round_tf32, stream_plan, unpack_weight, weight_resident)

TOL = 5e-5
COUTS = [3, 64, 216, 256, 300, 512]


def _n(cout):
    """The packed image's rows a (chunk, tap): its column blocks' N."""
    return column_blocks(cout)[0][1]


def _inputs(seed, cout, b=2, h=5, w=7, c1=64, c2=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c1)).astype(np.float32)
    x2 = rng.normal(size=(b, h, w, c2)).astype(np.float32) if c2 else None
    wgt = (rng.normal(size=(cout, c1 + c2, 3, 3))
           / (9 * (c1 + c2)) ** 0.5).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    res = rng.normal(size=(b, h, w, cout)).astype(np.float32)
    t = [None if a is None else torch.from_numpy(a)
         for a in (x, x2, wgt, bias, res)]
    return t, (x, x2, wgt, bias, res)


# the 128-byte-chunk cases (c1 64), then 32-byte chunks: 16 and 48 inputs
# and the (16 + 16) concat
PACK_CASES = [pytest.param(64, *case, id="-".join(map(str, case)))
              for case in ((3, 0, None, False), (64, 0, "relu", True),
                           (216, 0, "lrelu", False), (256, 0, None, True),
                           (64, 64, "lrelu", False), (3, 64, None, False),
                           (300, 0, None, True), (512, 0, "lrelu", False),
                           (512, 64, None, True))] + [
    pytest.param(16, 16, 0, "relu", False, id="narrow16-16"),
    pytest.param(16, 108, 0, "lrelu", False, id="narrow16-108"),
    pytest.param(48, 64, 0, None, True, id="narrow48-64"),
    pytest.param(16, 16, 16, "lrelu", False, id="narrow16+16-16"),
    pytest.param(16, 300, 16, None, True, id="narrow16+16-300")]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16_layout", "f32_layout"])
@pytest.mark.parametrize("c1,cout,c2,act,residual", PACK_CASES)
def test_packed_conv_matches_plain(dtype, c1, cout, c2, act, residual):
    """In the chunk the kernel takes for these widths and dtype (the layout
    only: the arithmetic is f32)."""
    (x, x2, wgt, bias, res), _ = _inputs(cout + c2, cout, c1=c1, c2=c2)
    res = res if residual else None
    ch = chunk(dtype, chunk_bytes(c1, c2, dtype))
    packed = pack_weight(wgt, _n(cout), ch)
    out = conv3x3_from_packed(x, packed, cout, bias, act, res, x2, ch=ch)
    ref = conv3x3_plain(x, wgt, bias, act, res, x2)
    assert out.shape == ref.shape == (2, 5, 7, cout)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=TOL)


@pytest.mark.parametrize("cout", COUTS)
def test_packed_conv_matches_jax_interpret(cout):
    """6 x 8: ragged against the kernel's 8 x 16 tile.  The JAX kernel
    needs W % 8 == 0, and an odd H (its row block falls to 1) gives it
    wrong rows, so H is even here; the odd 5 x 7 is held against
    ``conv3x3_plain`` above."""
    (x, _, wgt, bias, res), (xn, _, wn, bn, rn) = _inputs(cout + 1, cout,
                                                          h=6, w=8)
    ref = jax_conv3x3_fused(jnp.asarray(xn),
                            jnp.asarray(wn.transpose(2, 3, 1, 0)),
                            jnp.asarray(bn), act="lrelu",
                            residual=jnp.asarray(rn), mrows=4,
                            interpret=True)
    packed = pack_weight(wgt, _n(cout), chunk(torch.bfloat16))
    out = conv3x3_from_packed(x, packed, cout, bias, "lrelu", res, ch=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


def test_packed_conv_two_inputs_matches_jax_interpret():
    """The concat input (PCD's 64 + 64 -> 64) against the JAX kernel on the
    concatenated input."""
    (x, x2, wgt, bias, _), (xn, x2n, wn, bn, _) = _inputs(5, 64, h=6, w=16,
                                                          c2=64)
    ref = jax_conv3x3_fused(jnp.asarray(np.concatenate([xn, x2n], -1)),
                            jnp.asarray(wn.transpose(2, 3, 1, 0)),
                            jnp.asarray(bn), act="lrelu", mrows=4,
                            interpret=True)
    packed = pack_weight(wgt, 64, chunk(torch.float32))
    out = conv3x3_from_packed(x, packed, 64, bias, "lrelu", x2=x2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("c1,c2", [(16, 0), (16, 16)],
                         ids=["16", "16+16"])
def test_packed_narrow_conv_matches_jax_interpret(c1, c2):
    """The 32-byte-chunk layout (16 bf16 channels a chunk; x2's chunks after
    x1's) against the JAX kernel on the concatenated input, 6 x 16 (the
    JAX kernel's limits: even H, W % 8 == 0), 16 outputs."""
    (x, x2, wgt, bias, _), (xn, x2n, wn, bn, _) = _inputs(
        7 + c2, 16, h=6, w=16, c1=c1, c2=c2)
    xin = xn if x2n is None else np.concatenate([xn, x2n], -1)
    ref = jax_conv3x3_fused(jnp.asarray(xin),
                            jnp.asarray(wn.transpose(2, 3, 1, 0)),
                            jnp.asarray(bn), act="lrelu", mrows=4,
                            interpret=True)
    ch = chunk(torch.bfloat16, NARROW_LINE)
    packed = pack_weight(wgt, 16, ch)
    out = conv3x3_from_packed(x, packed, 16, bias, "lrelu", x2=x2, ch=ch)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("cout,cin,ch", [(3, 64, 64), (216, 128, 32),
                                         (64, 128, 64), (512, 128, 64),
                                         (300, 64, 32), (16, 16, 16),
                                         (108, 48, 16), (64, 16, 8),
                                         (300, 32, 8)])
def test_pack_layout_is_the_kernels(cout, cin, ch):
    """Element (o, i, dy, dx) sits at (((b * chunks + chunk) * 9 + tap) * n
    + o % n) * ch + ((k // u) ^ s(o)) * u + k % u, with b = o // n its
    column block of n outputs (one up to 256 outputs), chunk, k = divmod(i,
    ch), tap = 3 dy + dx and u the elements in 16 bytes: in a 128-byte
    chunk (64 bf16 / 32 f32 channels) u = ch / 8 and s(o) = o % 8, in a
    32-byte one (16 / 8) u = ch / 2 and s(o) = (o // 4) % 2 (the 32-byte
    swizzle: ``sm90.cuh::swizzle_of``); rows past cout are 0."""
    n = _n(cout)
    w = torch.arange(1, cout * cin * 9 + 1, dtype=torch.int64) \
        .view(cout, cin, 3, 3)
    packed = pack_weight(w, n, ch)
    assert packed.numel() == -(-cout // n) * cin // ch * 9 * n * ch
    wide = ch >= 32
    u = ch // 8 if wide else ch // 2
    want = torch.zeros_like(packed)
    o, i, dy, dx = np.meshgrid(np.arange(cout), np.arange(cin),
                               np.arange(3), np.arange(3), indexing="ij")
    c, k = np.divmod(i, ch)
    swz = o % 8 if wide else (o // 4) % 2
    at = ((((o // n) * (cin // ch) + c) * 9 + 3 * dy + dx) * n + o % n) \
        * ch + ((k // u) ^ swz) * u + k % u
    want[torch.from_numpy(at.reshape(-1))] = w.reshape(-1)
    assert torch.equal(packed, want)
    back = unpack_weight(packed, cout, cin, n, ch)
    assert torch.equal(back, w.permute(2, 3, 0, 1).reshape(
        9, cout, cin // ch, ch).permute(2, 0, 1, 3))


def test_routing_by_width():
    """Every conv runs the one wgmma kernel: whole 128-byte input chunks
    (every conv of the nf 64 and 128 model paths, EDVR-L's upconv1 (128 ->
    512) and any cout past 256 in column blocks), and 32-byte ones for the
    narrow inputs (the nf 16 debug configs' 16 and 16 + 16, and 48), at any
    cout.  The debug configs' weights are resident (one launch a call: the
    blocks lay them out); past 256 outputs or 48 -> 128 in f32 the weight
    is packed and streamed."""
    for dt in (torch.bfloat16, torch.float32):
        for c1, c2, cout in ((64, 0, 64), (64, 64, 64), (64, 0, 3),
                             (64, 0, 216), (64, 0, 256), (64, 64, 3),
                             (64, 0, 300), (128, 0, 512), (128, 128, 512)):
            assert chunk_bytes(c1, c2, dt) == LINE
        for c1, c2, cout in ((16, 16, 64), (48, 0, 64), (16, 0, 512),
                             (16, 16, 108), (64, 16, 64)):
            assert chunk_bytes(c1, c2, dt) == NARROW_LINE
        # the nf 16 debug configs' convs: resident, one launch
        for c1, c2, cout in ((16, 0, 16), (16, 16, 16), (16, 0, 108),
                             (16, 0, 64), (48, 0, 64)):
            assert weight_resident(c1, c2, cout, dt)
        assert not weight_resident(16, 0, 300, dt)
    # 32 channels: a whole 128-byte chunk in f32 only
    assert chunk_bytes(32, 0, torch.bfloat16) == NARROW_LINE
    assert chunk_bytes(32, 32, torch.float32) == LINE
    assert chunk(torch.bfloat16, NARROW_LINE) == 16
    assert chunk(torch.float32, NARROW_LINE) == 8
    assert not weight_resident(48, 0, 128, torch.float32)
    assert weight_resident(48, 0, 128, torch.bfloat16)
    assert column_blocks(512) == [(0, 256), (256, 256)]
    assert column_blocks(300) == [(0, 256), (256, 64)]
    assert column_blocks(257) == [(0, 256), (256, 8)]
    assert column_blocks(1000) == [(0, 256), (256, 256), (512, 256),
                                   (768, 256)]
    assert column_blocks(216) == [(0, 216)]
    assert column_blocks(472) == [(0, 256), (256, 216)]
    assert [kernel_width(c) for c in (1, 3, 8, 9, 20, 64, 65, 200, 216, 217,
                                      256)] == [8, 8, 8, 16, 32, 64, 128,
                                                216, 216, 256, 256]
    with pytest.raises(ValueError):
        kernel_width(257)


def test_round_tf32():
    """To nearest, ties away from 0, 10 mantissa bits kept."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=10000).astype(np.float32))
    r = round_tf32(x)
    assert not (r.view(torch.int32) & 0x1FFF).any()
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    one = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -12])
    assert round_tf32(one).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                        1.0]


def test_wgmma_header_is_up_to_date():
    assert gen_wgmma.HEADER.read_text() == gen_wgmma.render()
    assert WIDTHS == gen_wgmma.WIDTHS and WIDTHS[-1] == 256
    assert all(n % 8 == 0 for n in WIDTHS)


def test_stream_constants_are_the_kernel_source():
    """``conv3x3.py``'s mirror of the streamed regime (``conv3x3.cu`` note
    7: the cluster's blocks, the halo stages, the most weight slots, the
    widest N in clusters, the shared memory and its mbarriers) reads as the
    source states it, and gives EDVR-L's and the flagship's streamed convs
    the plans the note names: 9 slots at N 128 and 16 at N 64 in
    clusters, 5 at 216 and 4 at 256 without; the resident convs, column
    blocks past 256 and 32-byte chunks none."""
    import re

    src = (_build.CSRC / "conv3x3.cu").read_text()
    pair = re.search(r"constexpr int kPair = (\d+), kPairHalo = (\d+), "
                     r"kRingMax = (\d+), kRingSplit = (\d+);", src)
    assert tuple(map(int, pair.groups())) == (
        conv_mod.PAIR, conv_mod.PAIR_HALO, conv_mod.RING_MAX,
        conv_mod.RING_SPLIT)
    assert f"constexpr int kSmemMax = {conv_mod._SMEM_MAX};" in src
    assert "constexpr int kEpiRows = 16, kEpiPad = 8;" in src
    assert (conv_mod._EPI_ROWS, conv_mod._EPI_PAD) == (16, 8)
    assert "constexpr int kTH = 8, kTW = 16;" in src
    assert conv_mod._HALO_PIXELS == (8 + 2) * (16 + 2)
    assert "const int bar_bytes = 8 * (2 * 4 + 2 * 3 + 1);" in src
    assert conv_mod._BARS == 8 * (2 * 4 + 2 * 3 + 1)
    body = src[src.index("int plan_stream(Params& p, bool split, bool tma_epi) {"):
               src.index("// Shared memory of a launch")]
    assert ("const int most_bars = 8 * (2 * kPairHalo + 2 * kRingMax + 1);"
            in body)
    assert ("p.sw = (kSmemMax - kPairHalo * kStage - epi - most_bars) / "
            "slice;" in body)
    assert "if (p.sw > kRingMax) p.sw = kRingMax;" in body
    assert "if (split && p.sw > kRingSplit) {" in body
    assert "p.nres = p.sw - kRingSplit;" in body
    assert "if (p.nres > 9 * p.nchunk - 1) p.nres = 9 * p.nchunk - 1;" in body
    # every streamed one-block conv on 128-byte chunks takes plan_stream;
    # those up to kPairWidth run in clusters
    assert ("if (NL == 0 && CB == kLine && !p.resident)\n"
            "    return plan_stream<T, N>(p, false, false);" in src)
    launch = src[src.index("int launch_n("):src.index("// n: the wgmma width")]
    assert ("if constexpr (NL == 0 && CB == kLine && N <= kPairWidth) {"
            in launch)
    assert "if (!p.resident)  // the streamed regime in clusters (7)" in launch
    assert "attr.val.clusterDim.x = kPair;" in src
    assert f"constexpr int kPairWidth = {conv_mod.PAIR_WIDTH};" in src
    assert (f"constexpr int kEpiBufs = {conv_mod.EPI_BUFS}, kEpiBuf = "
            "kEpiRows * kLine," in src)
    assert "const int epi = tma_epi ? 8 * kEpiBufs * kEpiBuf" in body
    bf, f32 = torch.bfloat16, torch.float32
    # (ring slots, in clusters, resident slices) of EDVR-L's and the
    # flagship's streamed convs
    want = {(128, 0, 128, bf): (6, True, 3), (128, 128, 128, bf): (6, True, 3),
            (128, 0, 216, bf): (5, False, 0), (64, 0, 216, bf): (5, False, 0),
            (128, 0, 256, bf): (5, False, 0), (64, 0, 256, bf): (5, False, 0),
            (128, 0, 128, f32): (6, True, 3), (64, 64, 64, f32): (6, True, 12),
            (128, 128, 128, f32): (6, True, 3), (128, 0, 64, f32): (6, True, 12),
            (64, 0, 216, f32): (5, False, 0), (128, 0, 256, f32): (5, False, 0),
            (128, 0, 216, f32): (5, False, 0),
            (2048, 0, 8, bf): (6, True, 142), (2048, 0, 8, f32): (6, True, 142)}
    for (c1, c2, cout, dt), (slots, pair, res) in want.items():
        plan = stream_plan(c1, c2, cout, dt)
        assert plan == (2, slots, pair, res)
        n = kernel_width(cout)
        # the plan fits a block: ring and resident slices, halo stages,
        # epilogue (the TMA stores' staging, or at 256 the resident
        # convs'), mbarriers
        es = dt.itemsize
        epi = (8 * 16 * (LINE // es + 8) * es if n == 256 or (
            n == 216 and dt == f32) else 8 * 2 * 16 * LINE)
        used = ((slots + res) * n * LINE + 2 * 23552 + epi
                + 8 * (2 * 2 + 2 * slots + 1))
        assert used <= conv_mod._SMEM_MAX
        assert conv_mod.scratch_elements(c1, c2, cout, dt) == (
            n * (c1 + c2) * 9)
    # at 216 a residual takes the resident convs' epilogue, whose smaller
    # staging leaves one more slot in bf16 (6); 256 takes it always
    assert stream_plan(64, 0, 216, bf, True) == (2, 6, False, 0)
    assert stream_plan(64, 0, 256, bf, True) == (2, 5, False, 0)
    assert stream_plan(128, 0, 128, bf, True) == (2, 6, True, 3)
    assert ("const bool tma_out = NL == 0 && CB == kLine && N == "
            "kTmaOutWidth &&\n                       sizeof(T) == 2 &&" in src)
    assert f"kTmaOutWidth = {conv_mod.TMA_OUT_WIDTH};" in src
    for c1, c2, cout, dt in ((64, 0, 64, bf), (64, 64, 64, bf),
                             (128, 0, 64, bf), (64, 0, 64, f32),
                             (128, 0, 512, bf), (128, 0, 300, f32),
                             (16, 16, 16, bf), (48, 0, 128, f32)):
        assert stream_plan(c1, c2, cout, dt) is None
