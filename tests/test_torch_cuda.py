"""The port's CUDA kernels against their plain versions on the card.

Marked ``gpu``: each test asks the ``cuda`` fixture, which skips where
there is no CUDA device (decided when the test runs, never at import).  On
a machine with an H100 and nvcc:

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX, which the port and
this file do not use.)
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realvsr_tpu_torch.ops.kernels.check import (conv3x3_plain_grads,
                                                 grad_tolerance, max_abs_err,
                                                 slope_mismatches, tolerance)
from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
from realvsr_tpu_torch.ops.deform_conv_block import (
    modulated_deform_conv_block)
from realvsr_tpu_torch.ops.kernels.conv3x3 import (chunk, chunk_bytes,
                                                   column_blocks, conv3x3,
                                                   conv3x3_autograd,
                                                   conv3x3_fused,
                                                   conv3x3_narrow,
                                                   conv3x3_plain, pack_weight,
                                                   pack_weight_cuda,
                                                   round_tf32, stream_plan)
from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd, dcn_bwd_om,
                                               dcn_bwd_om_plain,
                                               dcn_bwd_plain, dcn_fwd,
                                               dcn_fwd_om, dcn_fwd_om_plain,
                                               dcn_fwd_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _dcn_inputs(shape, dtype, dev, seed=0, dg=8, std=2.5):
    b, h, w, c = shape
    g = _gen(seed)
    x = torch.randn(b, h, w, c, generator=g)
    off = torch.randn(b, h, w, dg * 18, generator=g) * std  # std 2.5: some
    mask = torch.rand(b, h, w, dg * 9, generator=g)         # beyond ±4
    wgt = (torch.rand(64, c, 3, 3, generator=g) * 2 - 1) / (9 * c) ** 0.5
    bias = torch.randn(64, generator=g) * 0.1
    return [t.to(dev, dtype) for t in (x, off, mask, wgt, bias)]


def _om(off, mask):
    """DCNPack's offset/mask tensor: the offsets, then mask logits."""
    return torch.cat([off, torch.logit(mask.float(), eps=1e-3)
                      .to(off.dtype)], -1).contiguous()


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,act,max_offset", [
    ((3, 128, 256, 64), "lrelu", 4),     # the L3 DCN
    ((1, 37, 45, 64), None, None),       # ragged tile edges
    ((2, 64, 128, 64), None, 4),
    ((2, 13, 70, 64), "relu", 8),        # ragged, fewer rows than a tile
])
def test_dcn_kernel_matches_plain(cuda, dtype, shape, act, max_offset, om):
    """Both forms: the separate offsets and mask, and DCNPack's
    offset/mask tensor read in place (sigmoid in the kernel)."""
    x, off, mask, wgt, bias = _dcn_inputs(shape, dtype, cuda)
    n = dcn_fwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, 8, act=act, max_offset=max_offset)
        ref = dcn_fwd_om_plain(x, t, wgt, bias, 8, act, max_offset)
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, 8, act=act,
                      max_offset=max_offset)
        ref = dcn_fwd_plain(x, off, mask, wgt, bias, 8, act, max_offset)
    torch.cuda.synchronize()
    assert dcn_fwd.launches == n + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert max_abs_err(out, ref) <= tolerance(ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,c2,act,residual", [
    ((3, 128, 256, 64), 0, "relu", False),
    ((3, 128, 256, 64), 0, None, True),
    ((3, 128, 256, 64), 64, "lrelu", False),
    ((3, 37, 45, 64), 0, "relu", True),    # tile walk across images
    ((3, 37, 45, 64), 64, "lrelu", False),  # ... with the concat input
    ((2, 96, 512, 64), 64, None, False),   # many tiles per block
    ((2, 37, 45, 16), 16, "relu", True),  # narrow inputs: 32-byte chunks
    ((1, 20, 24, 48), 0, None, True),     # 48 inputs: 32-byte chunks
])
def test_conv3x3_kernel_matches_plain(cuda, dtype, shape, c2, act, residual):
    b, h, w, c1 = shape
    g = _gen(1)
    x = torch.randn(b, h, w, c1, generator=g).to(cuda, dtype)
    x2 = torch.randn(b, h, w, c2, generator=g).to(cuda, dtype) if c2 else None
    wgt = ((torch.rand(64, c1 + c2, 3, 3, generator=g) * 2 - 1)
           / (9 * (c1 + c2)) ** 0.5).to(cuda, dtype)
    bias = (torch.randn(64, generator=g) * 0.1).to(cuda, dtype)
    res = torch.randn(b, h, w, 64, generator=g).to(cuda, dtype) \
        if residual else None
    n = (conv3x3.launches, conv3x3_narrow.launches)
    out = conv3x3(x, wgt, bias, act, res, x2)
    torch.cuda.synchronize()
    assert conv3x3.launches == n[0] + 1
    assert conv3x3_narrow.launches == n[1] + (c1 % chunk(dtype) != 0)
    ref = conv3x3_plain(x, wgt, bias, act, res, x2)
    assert max_abs_err(out, ref) <= tolerance(ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cout,cin", [(3, 64), (64, 128), (216, 64),
                                      (256, 128), (512, 128), (300, 64),
                                      (108, 16), (128, 48), (300, 16)])
def test_conv3x3_weight_packer_matches_plain(cuda, dtype, cout, cin):
    """The kernel's packer lays the weight out exactly as pack_weight,
    rounded to TF32 for f32; past 256 outputs in column blocks of 256; in
    32-byte chunks for narrow inputs (their streamed form)."""
    w = torch.randn(cout, cin, 3, 3, generator=_gen(14)).to(cuda, dtype)
    n = column_blocks(cout)[0][1]
    line = chunk_bytes(cin, 0, dtype)
    ref = pack_weight(w, n, chunk(dtype, line))
    if dtype == torch.float32:
        ref = round_tf32(ref)
    assert torch.equal(pack_weight_cuda(w, n, line), ref)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn(1, 8, 32, 64, device=cuda)
    w = torch.randn(64, 64, 3, 3, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="dtype"):
        conv3x3(x.half(), w.half())
    with pytest.raises(ValueError, match="bias"):
        conv3x3(x, torch.randn(32, 64, 3, 3, device=cuda),
                torch.randn(64, device=cuda))
    with pytest.raises(ValueError, match="multiples of 16"):
        conv3x3(x[..., :40].contiguous(), w[:, :40].contiguous())
    with pytest.raises(ValueError, match="offset"):
        dcn_fwd(x, torch.zeros(1, 8, 32, 8, device=cuda),
                torch.zeros(1, 8, 32, 72, device=cuda), w)
    with pytest.raises(ValueError, match="om"):
        dcn_fwd_om(x, torch.zeros(1, 8, 32, 144, device=cuda), w)
    with pytest.raises(ValueError, match="om must be contiguous"):
        dcn_bwd_om(x, torch.zeros(1, 8, 32, 432, device=cuda)[..., :216], w,
                   torch.zeros(1, 8, 32, 64, device=cuda))
    with pytest.raises(ValueError, match="deformable groups"):
        dcn_fwd_om(x, torch.zeros(1, 8, 32, 135, device=cuda), w,
                   deformable_groups=5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,c2,cout,act,bias,residual", [
    ((3, 64, 128, 64), 0, 3, None, True, False),     # TDAN reconstruction
    ((3, 64, 128, 64), 0, 3, None, False, False),    # TDAN final_conv
    ((3, 64, 128, 64), 0, 216, "lrelu", True, False),
    ((1, 64, 128, 64), 0, 256, None, True, True),    # EDVR upconv2
    ((2, 37, 45, 64), 64, 3, "relu", True, False),   # ragged, two inputs
    ((3, 37, 45, 64), 0, 216, "lrelu", True, False),  # streamed weights
    ((3, 37, 45, 64), 0, 256, None, True, True),     # across images
    ((2, 37, 45, 64), 64, 256, "lrelu", True, False),  # 2 chunks streamed
    ((2, 40, 48, 64), 0, 20, "relu", True, True),    # N = 32, ragged cout
    ((2, 37, 45, 16), 0, 20, "lrelu", True, True),   # narrow: N = 32
    ((1, 20, 24, 64), 0, 300, None, True, False),    # 256 + 64 columns
    ((2, 37, 45, 64), 0, 300, "lrelu", True, True),  # ... ragged, +res
    ((2, 21, 37, 64), 64, 512, None, False, True),   # 256 + 256, two inputs
    ((1, 20, 24, 16), 0, 300, None, True, True),     # narrow past 256
    ((2, 21, 37, 48), 0, 128, "lrelu", True, False),  # 48: f32 streams
    ((3, 37, 45, 16), 16, 108, "lrelu", True, False),  # 16+16 -> 108
])
def test_conv3x3_any_width_matches_plain(cuda, dtype, shape, c2, cout, act,
                                         bias, residual):
    b, h, w, c1 = shape
    g = _gen(9)
    x = torch.randn(b, h, w, c1, generator=g).to(cuda, dtype)
    x2 = torch.randn(b, h, w, c2, generator=g).to(cuda, dtype) if c2 else None
    wgt = ((torch.rand(cout, c1 + c2, 3, 3, generator=g) * 2 - 1)
           / (9 * (c1 + c2)) ** 0.5).to(cuda, dtype)
    bs = (torch.randn(cout, generator=g) * 0.1).to(cuda, dtype) \
        if bias else None
    res = torch.randn(b, h, w, cout, generator=g).to(cuda, dtype) \
        if residual else None
    n = (conv3x3.launches, conv3x3_fused.launches)
    out = (conv3x3(x, wgt, bs, act, res, x2) if c2
           else conv3x3_fused(x, wgt, bs, act, res))
    torch.cuda.synchronize()
    assert (conv3x3.launches, conv3x3_fused.launches) == (n[0], n[1] + 1)
    ref = conv3x3_plain(x, wgt, bs, act, res, x2)
    assert out.shape == ref.shape == (b, h, w, cout)
    assert max_abs_err(out, ref) <= tolerance(ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c1,c2,cout,act,residual", [
    (128, 0, 128, "relu", False),     # a ResBlock's conv1
    (128, 0, 128, None, True),        # its conv2, + the residual
    (128, 128, 128, "lrelu", False),  # PCD's concat(nbr, ref) offset convs
    (128, 0, 216, "lrelu", False),    # conv_offset_mask, 8 groups
    (128, 0, 256, "lrelu", False),    # upconv2
    (128, 0, 512, "lrelu", False),    # upconv1: two column blocks of 256
], ids=["128-128relu", "128-128res", "256-128lrelu", "128-216", "128-256",
        "128-512wgmma"])
def test_conv3x3_edvr_l_widths_match_plain(cuda, dtype, c1, c2, cout, act,
                                           residual):
    """EDVR-L's (nf 128) conv widths on a ragged shape, all on the wgmma
    kernel (cout 512 in two column blocks of 256)."""
    g = _gen(11)
    shape = (2, 21, 37)
    x = torch.randn(*shape, c1, generator=g).to(cuda, dtype)
    x2 = torch.randn(*shape, c2, generator=g).to(cuda, dtype) if c2 else None
    w = ((torch.rand(cout, c1 + c2, 3, 3, generator=g) * 2 - 1)
         / (9 * (c1 + c2)) ** 0.5).to(cuda, dtype)
    b = (torch.randn(cout, generator=g) * 0.1).to(cuda, dtype)
    res = (torch.randn(*shape, cout, generator=g).to(cuda, dtype)
           if residual else None)
    n = (conv3x3_fused.launches, conv3x3_narrow.launches)
    out = conv3x3(x, w, b, act, res, x2)
    ref = conv3x3_plain(x, w, b, act, res, x2)
    torch.cuda.synchronize()
    assert (conv3x3_fused.launches, conv3x3_narrow.launches) == (n[0] + 1,
                                                                 n[1])
    assert max_abs_err(out, ref) <= tolerance(ref)


# the streamed regime (a ring as deep as shared memory allows; up to 128
# outputs in clusters of two blocks, each weight slice multicast to both):
# (c1, c2, cout, act, residual, pixels (b, h, w)), in bf16 and f32 but
# (64+64)->64 and 128->64, streamed in f32 only
_BF, _F32 = torch.bfloat16, torch.float32
STREAMED = [(dt, *case) for dt in (_BF, _F32) for case in (
    (128, 0, 128, None, True, (2, 64, 96)),        # a ResBlock's conv2
    (128, 128, 128, "lrelu", False, (2, 64, 96)),  # PCD 256 (128+128)->128
    (64, 0, 216, "lrelu", False, (2, 64, 96)),     # conv_offset_mask
    (128, 0, 256, "lrelu", True, (1, 40, 64)),     # upconv2's width
    (128, 0, 128, "relu", False, (1, 8, 48)),      # 3 tiles: odd, < SMs
    (128, 0, 128, "relu", True, (2, 37, 45)),      # ragged H and W
    (128, 0, 128, None, False, (2, 256, 448)),     # ~14 tiles a block
    (2048, 0, 8, "relu", True, (1, 8, 16)),        # one tile; N 8
    (1024, 0, 20, None, True, (1, 21, 37)),   # rows of 20: bf16 not in 16 B
)] + [(_F32, 64, 64, 64, "lrelu", False, (2, 64, 96)),  # PCD L1 (64+64)
      (_F32, 128, 0, 64, None, True, (3, 24, 40))]


@pytest.mark.parametrize("dtype,c1,c2,cout,act,residual,pix", STREAMED,
                         ids=[f"{str(c[0])[6:]}-{c[1]}+{c[2]}-{c[3]}-"
                              f"{'x'.join(map(str, c[6]))}"
                              for c in STREAMED])
def test_conv3x3_streamed_weights_match_plain(cuda, dtype, c1, c2, cout, act,
                                              residual, pix):
    """Every conv whose weight outgrows shared memory at cout <= 256 on
    128-byte chunks runs the streamed regime (``conv3x3.cu`` note 7): a
    ring as deep as shared memory allows, and up to 128 outputs clusters of
    two blocks, each weight slice multicast to both.  Where the tiles are
    odd in number (3; 1) the second block of the last cluster takes the
    last tile again and stores nothing."""
    g = _gen(21)
    x = torch.randn(*pix, c1, generator=g).to(cuda, dtype)
    x2 = torch.randn(*pix, c2, generator=g).to(cuda, dtype) if c2 else None
    w = ((torch.rand(cout, c1 + c2, 3, 3, generator=g) * 2 - 1)
         / (9 * (c1 + c2)) ** 0.5).to(cuda, dtype)
    b = (torch.randn(cout, generator=g) * 0.1).to(cuda, dtype)
    res = (torch.randn(*pix, cout, generator=g).to(cuda, dtype)
           if residual else None)
    assert stream_plan(c1, c2, cout, dtype) is not None
    n = (conv3x3.launches, conv3x3_fused.launches)
    out = conv3x3(x, w, b, act, res, x2)
    ref = conv3x3_plain(x, w, b, act, res, x2)
    torch.cuda.synchronize()
    assert conv3x3.launches + conv3x3_fused.launches == sum(n) + 1
    assert out.shape == ref.shape == (*pix, cout)
    assert torch.isfinite(out).all()
    assert max_abs_err(out, ref) <= tolerance(ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv3x3_any_width_autograd_matches_plain_autograd(cuda, dtype):
    """64 -> 3 without bias (TDAN's final_conv), as the 64-out autograd
    test holds it."""
    g = _gen(10)
    x = torch.randn(2, 40, 72, 64, generator=g).to(cuda, dtype) \
        .requires_grad_()
    w = (torch.randn(3, 64, 3, 3, generator=g) / 24).to(cuda, dtype) \
        .requires_grad_()
    cot = torch.randn(2, 40, 72, 3, generator=g).to(cuda, dtype)
    out = conv3x3_autograd(x, w)
    ours = torch.autograd.grad(out, (x, w), cot)
    ref = conv3x3_plain_grads(out, cot, [x, w], x, w)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and max_abs_err(o, r) <= grad_tolerance(r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_offset,with_mask", [(4, True), (8, True),
                                                  (2, False)])
def test_block_api_matches_plain(cuda, dtype, max_offset, with_mask):
    x, off, mask, wgt, bias = _dcn_inputs((2, 64, 128, 64), dtype, cuda,
                                          seed=11)
    m = mask if with_mask else None
    n = (modulated_deform_conv_block.launches, dcn_fwd.launches)
    out = modulated_deform_conv_block(x, off, m, wgt, bias,
                                      deformable_groups=8,
                                      max_offset=max_offset)
    torch.cuda.synchronize()
    assert (modulated_deform_conv_block.launches, dcn_fwd.launches) == \
        (n[0] + 1, n[1])
    ref = modulated_deform_conv_plain(x, off, m, wgt, bias, 1, 1, 1, 8,
                                      max_offset)
    assert max_abs_err(out, ref) <= tolerance(ref)


def test_edvr_on_card_matches_cpu(cuda):
    """Full width (nf 64, 8 groups), cut depth and size: the card in f32
    (TF32 kernels) against the CPU in f32."""
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    cfg = dict(nf=64, nframes=3, groups=8, front_RBs=1, back_RBs=1,
               dcn_max_offset=4)
    cpu = EDVRNoUp(**cfg, device="cpu", generator=_gen(2)).eval()
    g = _gen(3)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "conv_offset_mask" in name:
                p.copy_(torch.randn(p.shape, generator=g))
    card = EDVRNoUp(**cfg, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, 3, 32, 64, 3, generator=g)
    n = (dcn_fwd.launches, conv3x3.launches)
    with torch.inference_mode():
        ref = cpu(x)
        out = card(x.to(cuda)).cpu()
    assert (dcn_fwd.launches - n[0], conv3x3.launches - n[1]) == (4, 19)
    assert torch.isfinite(out).all()
    assert np.abs((out - ref).numpy()).max() <= 2e-2


@pytest.mark.parametrize("name,counts", [("TDAN", (4, 9, 6)),
                                         ("EDVR", (4, 25, 7))])
def test_tdan_and_edvr_x4_on_card_match_cpu(cuda, name, counts):
    """Full width (nf 64, 8 groups), cut depth and size, f32: the card
    (TF32 kernels) against the CPU; launches of dcn_fwd, the 64-out and
    the other-width conv3x3."""
    from realvsr_tpu_torch.models.edvr import EDVR
    from realvsr_tpu_torch.models.tdan import TDAN

    if name == "TDAN":
        cls, cfg = TDAN, dict(nf=64, nframes=3, scale=1, nb_f=1, nb_b=1)
    else:
        cls, cfg = EDVR, dict(nf=64, nframes=5, front_RBs=1, back_RBs=1,
                              w_TSA=True)
    cfg.update(groups=8, dcn_max_offset=4)
    cpu = cls(**cfg, device="cpu", generator=_gen(12)).eval()
    g = _gen(13)
    with torch.no_grad():
        for pname, p in cpu.named_parameters():
            if "conv_offset_mask" in pname:
                p.copy_(torch.randn(p.shape, generator=g) * 0.3)
    card = cls(**cfg, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, cfg["nframes"], 32, 64, 3, generator=g)
    n = (dcn_fwd.launches, conv3x3.launches, conv3x3_fused.launches)
    with torch.inference_mode():
        ref = cpu(x)
        out = card(x.to(cuda)).cpu()
    assert (dcn_fwd.launches - n[0], conv3x3.launches - n[1],
            conv3x3_fused.launches - n[2]) == counts
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert np.abs((out - ref).numpy()).max() <= 2e-2


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,max_offset,std", [
    ((1, 37, 45, 64), 8, 2.5),       # ragged tile edges, taps outside
    ((2, 48, 64, 64), None, 2.5),
    ((2, 48, 64, 64), 2, 2.5),       # many offsets beyond the clamp
    ((1, 32, 40, 64), None, 0.0),    # on the grid: one-sided differences
    # corners outside the dx footprint: the global path (no clamp, and a
    # clamp wider than the footprint's radius of 8)
    ((1, 40, 72, 64), None, 12.0),
    ((1, 40, 72, 64), 12, 12.0),
])
def test_dcn_bwd_kernel_matches_plain(cuda, dtype, shape, max_offset, std,
                                      om):
    x, off, mask, wgt, _ = _dcn_inputs(shape, dtype, cuda, seed=4, std=std)
    g = torch.randn(*shape[:3], 64, generator=_gen(5)).to(cuda, dtype)
    n = dcn_bwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_bwd_om(x, t, wgt, g, 8, max_offset)
        ref = dcn_bwd_om_plain(x, t, wgt, g, 8, max_offset)
        names = ("dx", "dom", "dweight")
        doff = out[1][..., :8 * 18]
    else:
        out = dcn_bwd(x, off, mask, wgt, g, 8, max_offset)
        ref = dcn_bwd_plain(x, off, mask, wgt, g, 8, max_offset)
        names = ("dx", "doffset", "dmask", "dweight")
        doff = out[1]
    torch.cuda.synchronize()
    assert dcn_bwd.launches == n + 1
    for name, o, r in zip(names, out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        assert max_abs_err(o, r) <= grad_tolerance(r), name
    if max_offset is not None:
        assert not doff[off.abs() > max_offset].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c2,act,residual", [(0, None, True),
                                              (64, None, False),
                                              (0, "relu", False),
                                              (64, "lrelu", False)])
def test_conv3x3_autograd_matches_plain_autograd(cuda, dtype, c2, act,
                                                 residual):
    """Each gradient within check.grad_tolerance of the plain autograd, the
    activation's slope taken from the kernel's output; that slope equals
    the plain f32 one outside the rounding of 0 (see check.py)."""
    g = _gen(6)

    def t(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(
            cuda, dtype).requires_grad_()

    x = t(2, 40, 72, 64)
    x2 = t(2, 40, 72, c2) if c2 else None
    w = t(64, 64 + c2, 3, 3, scale=(9 * (64 + c2)) ** -0.5)
    b = t(64, scale=0.1)
    res = t(2, 40, 72, 64) if residual else None
    cot = torch.randn(2, 40, 72, 64, generator=g).to(cuda, dtype)
    leaves = [v for v in (x, w, b, res, x2) if v is not None]
    n = conv3x3.launches
    out = conv3x3_autograd(x, w, b, act, res, x2)
    ours = torch.autograd.grad(out, leaves, cot)
    assert conv3x3.launches == n + 1
    ref = conv3x3_plain_grads(out, cot, leaves, x, w, b, act, res, x2)
    for o, r in zip(ours, ref):
        assert o.dtype == r.dtype and max_abs_err(o, r) <= grad_tolerance(r)
    if act is not None:
        assert slope_mismatches(out, x, w, b, act, x2)[0] == 0


def test_train_step_on_card_matches_cpu(cuda):
    """One Split step at full width (nf 64, 8 groups: the kernels write 64
    channels), cut depth, 64x64, batch 2, f32: the card (TF32 kernels)
    against the CPU from the same weights and batch; loss to 1e-3
    relative, each gradient to 5e-2 of its largest magnitude."""
    import os

    import yaml

    from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset
    from realvsr_tpu_torch.models.edvr import EDVRNoUp
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "train",
                           "train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")
    cfg = dict(nf=64, nframes=3, groups=8, front_RBs=1, back_RBs=1,
               dcn_max_offset=8)
    cpu = EDVRNoUp(**cfg, device="cpu", generator=_gen(7))
    g = _gen(8)
    with torch.no_grad():
        for name, p in cpu.named_parameters():
            if "conv_offset_mask" in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    ds = SyntheticVSRDataset(dict(N_frames=3, GT_size=64))
    items = [ds.get(i, np.random.default_rng(i)) for i in (1, 9)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}
    grads, losses = {}, {}
    n = (dcn_fwd.launches, dcn_bwd.launches, conv3x3.launches)
    for dev in ("cpu", cuda):
        model = EDVRNoUp(**cfg, device=dev)
        model.load_state_dict(cpu.state_dict())
        state = create_train_state(model, opt)
        _, logs = make_split_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[str(dev)] = logs["l_pix"].item()
        grads[str(dev)] = {k: p.grad.float().cpu()
                           for k, p in model.named_parameters()}
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1],
            conv3x3.launches - n[2]) == (4, 4, 19)
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-3)
    for k, ref in grads["cpu"].items():
        err = (grads["cuda"][k] - ref).abs().max().item()
        assert err <= 5e-2 * ref.abs().max().item(), k


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(28, 16, 16, 64), (28, 32, 32, 64)])
def test_dcn_bwd_kernel_on_planes_narrower_than_a_tile(cuda, dtype, shape,
                                                       om):
    """EDVR x4's L3 and L2 DCN planes (16 and 32 wide: every backward tile
    of 32 pixels reaches the right edge or past it), ±8 as training clamps,
    offsets of std 2.5 px."""
    x, off, mask, wgt, _ = _dcn_inputs(shape, dtype, cuda, seed=6)
    g = torch.randn(*shape[:3], 64, generator=_gen(7)).to(cuda, dtype)
    n = dcn_bwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_bwd_om(x, t, wgt, g, 8, 8)
        ref = dcn_bwd_om_plain(x, t, wgt, g, 8, 8)
        names = ("dx", "dom", "dweight")
    else:
        out = dcn_bwd(x, off, mask, wgt, g, 8, 8)
        ref = dcn_bwd_plain(x, off, mask, wgt, g, 8, 8)
        names = ("dx", "doffset", "dmask", "dweight")
    torch.cuda.synchronize()
    assert dcn_bwd.launches == n + 1
    for name, o, r in zip(names, out, ref):
        assert o.shape == r.shape and o.dtype == r.dtype, name
        assert torch.isfinite(o).all(), name
        assert max_abs_err(o, r) <= grad_tolerance(r), name


@pytest.mark.parametrize("recipe,cuts,side,counts", [
    ("train_TDAN_RealVSR_YCbCr_Split.yml", dict(nb_f=1, nb_b=1), 64,
     (4, 4, 9, 6)),
    ("train_EDVRx4_TSA_Vimeo90K.yml",
     dict(front_RBs=1, back_RBs=1, nframes=5), 32, (4, 4, 25, 7)),
], ids=["TDAN", "EDVRx4_TSA"])
def test_tdan_and_edvr_x4_train_steps_on_card_match_cpu(cuda, recipe, cuts,
                                                        side, counts):
    """``chip_smoke.py``'s card-vs-CPU steps of the two families: the
    recipe's network at full width and cut depth (TDAN nf 64, 1 + 1
    ResBlocks, LQ 64x64; EDVR x4 + TSA nf 64, 8 groups, 1 + 1 ResBlocks, 5
    frames, LQ 32x32), batch 2 of motion-synthetic frames, f32, the card
    (TF32 kernels) against the CPU from the same weights (offset convs
    randomised); loss to 1e-3 relative, each gradient to 5e-2 of its
    largest magnitude plus the CPU's own change in it when the LQ input
    moves by TF32's rounding (2^-11 relative); launches of dcn_fwd,
    dcn_bwd, the 64-out and the other-width conv3x3.  TSA's spatial
    attention (``sAtt_1``, ``sAtt_L1``: lrelu and 3x3 max pools after
    them) is the closest to that bound (PERF.md §7)."""
    import os

    import yaml

    from realvsr_tpu_torch.data.synthetic import SyntheticMotionVSRDataset
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "train", recipe)) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")
    opt["network_G"].update(cuts)
    scale, n_frames = opt["scale"], opt["network_G"]["nframes"]
    cpu = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    g = _gen(13)
    with torch.no_grad():
        for pname, p in cpu.named_parameters():
            if "conv_offset_mask" in pname:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    ds = SyntheticMotionVSRDataset(dict(
        N_frames=n_frames, GT_size=side * scale, scale=scale,
        frame_h=side * scale + 32, frame_w=side * scale + 32))
    items = [ds.get(i, np.random.default_rng(i)) for i in (3, 17)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}
    grads, losses = {}, {}
    for dev in ("cpu", cuda):
        model = define_g(opt, device=dev, dcn_max_offset=8)
        model.load_state_dict(cpu.state_dict())
        state = create_train_state(model, opt)
        n = (dcn_fwd.launches, dcn_bwd.launches, conv3x3.launches,
             conv3x3_fused.launches)
        _, logs = make_split_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[str(dev)] = logs["l_pix"].item()
        grads[str(dev)] = {k: p.grad.float().cpu()
                           for k, p in model.named_parameters()}
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1],
            conv3x3.launches - n[2], conv3x3_fused.launches - n[3]) == counts
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-3)
    lq = batch["LQs"]
    noisy = dict(batch, LQs=lq * (1 + 2.0 ** -11 * torch.randn(
        lq.shape, generator=_gen(16))))
    model = define_g(opt, device="cpu", dcn_max_offset=8)
    model.load_state_dict(cpu.state_dict())
    make_split_train_step(model, opt)(create_train_state(model, opt), noisy,
                                      torch.Generator())
    for k, p in model.named_parameters():
        ref = grads["cpu"][k]
        spread = (p.grad - ref).abs().max().item()
        err = (grads["cuda"][k] - ref).abs().max().item()
        assert err <= 5e-2 * ref.abs().max().item() + spread, k


def _narrow_inputs(shape, dtype, dev, seed=0, std=2.5):
    """16 channels in 4 deformable groups (csrc/dcn_narrow.cu)."""
    b, h, w, c = shape
    g = _gen(seed)
    x = torch.randn(b, h, w, c, generator=g)
    off = torch.randn(b, h, w, 4 * 18, generator=g) * std
    mask = torch.rand(b, h, w, 4 * 9, generator=g)
    wgt = (torch.rand(c, c, 3, 3, generator=g) * 2 - 1) / (9 * c) ** 0.5
    bias = torch.randn(c, generator=g) * 0.1
    gout = torch.randn(b, h, w, c, generator=g)
    return [t.to(dev, dtype) for t in (x, off, mask, wgt, bias, gout)]


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,act,max_offset", [
    ((12, 64, 64, 16), None, 8),      # the debug config's L1, its clamp
    ((12, 64, 64, 16), "lrelu", 4),
    ((1, 37, 45, 16), None, None),    # ragged runs, taps outside
    ((2, 13, 70, 16), "relu", 8),
])
def test_dcn_narrow_kernels_match_plain(cuda, dtype, shape, act, max_offset,
                                        om):
    """The forward and backward at 16 channels in 4 groups, both forms."""
    x, off, mask, wgt, bias, g = _narrow_inputs(shape, dtype, cuda)
    n = (dcn_fwd.launches, dcn_bwd.launches)
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, 4, act=act, max_offset=max_offset)
        ref = dcn_fwd_om_plain(x, t, wgt, bias, 4, act, max_offset)
        grads = dcn_bwd_om(x, t, wgt, g, 4, max_offset)
        grefs = dcn_bwd_om_plain(x, t, wgt, g, 4, max_offset)
        doff = grads[1][..., :4 * 18]
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, 4, act=act,
                      max_offset=max_offset)
        ref = dcn_fwd_plain(x, off, mask, wgt, bias, 4, act, max_offset)
        grads = dcn_bwd(x, off, mask, wgt, g, 4, max_offset)
        grefs = dcn_bwd_plain(x, off, mask, wgt, g, 4, max_offset)
        doff = grads[1]
    torch.cuda.synchronize()
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1]) == (1, 1)
    assert out.shape == ref.shape and out.dtype == dtype
    assert max_abs_err(out, ref) <= tolerance(ref)
    for o, r in zip(grads, grefs):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert max_abs_err(o, r) <= grad_tolerance(r)
    if max_offset is not None:
        assert not doff[off.abs() > max_offset].any()


def test_dcn_rejects_other_widths_without_fallback(cuda):
    """The kernels' domain is the TPU kernel's: C = 256 in 8 groups, 128 in
    4, 96 in 8 (refused before they were widened) and 64 -> 32 launch
    ``dcn_narrow.cu``, one launch a call in every form and the block API;
    the one shape left without a kernel, 48 in 5 (groups not dividing the
    input channels, which JAX cannot run either), raises a ValueError with
    no launch and no plain fallback."""
    for c, dg, cout in ((256, 8, 256), (128, 4, 128), (96, 8, 96),
                        (64, 8, 32)):
        x, off, mask, wgt, bias, g = _width_inputs((1, 8, 16, c), dg,
                                                   torch.float32, cuda,
                                                   cout=cout)
        n = (dcn_fwd.launches, dcn_bwd.launches,
             modulated_deform_conv_block.launches)
        t = _om(off, mask)
        outs = [dcn_fwd(x, off, mask, wgt, bias, dg),
                dcn_fwd_om(x, t, wgt, bias, dg),
                modulated_deform_conv_block(x, off, mask, wgt, bias,
                                            deformable_groups=dg,
                                            max_offset=4)]
        grads = [dcn_bwd(x, off, mask, wgt, g, dg),
                 dcn_bwd_om(x, t, wgt, g, dg)]
        torch.cuda.synchronize()
        assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1],
                modulated_deform_conv_block.launches - n[2]) == (2, 2, 1)
        assert all(o.shape == (1, 8, 16, cout) for o in outs)
        assert grads[0][3].shape == grads[1][2].shape == (cout, c, 3, 3)
    n = (dcn_fwd.launches, dcn_bwd.launches)
    c, dg = 48, 5
    x = torch.randn(1, 8, 16, c, device=cuda)
    w = torch.randn(c, c, 3, 3, device=cuda)
    off = torch.zeros(1, 8, 16, dg * 18, device=cuda)
    mask = torch.zeros(1, 8, 16, dg * 9, device=cuda)
    with pytest.raises(ValueError, match="groups must divide"):
        dcn_fwd(x, off, mask, w, None, dg)
    with pytest.raises(ValueError, match="groups must divide"):
        dcn_fwd_om(x, _om(off, mask + 0.5), w, None, dg)
    with pytest.raises(ValueError, match="groups must divide"):
        dcn_bwd(x, off, mask, w, torch.zeros_like(x), dg)
    with pytest.raises(ValueError, match="groups must divide"):
        dcn_bwd_om(x, _om(off, mask + 0.5), w, torch.zeros_like(x), dg)
    with pytest.raises(ValueError, match="groups must divide"):
        modulated_deform_conv_block(x, off, mask, w, None,
                                    deformable_groups=dg, max_offset=4)
    assert (dcn_fwd.launches, dcn_bwd.launches) == n


def _width_inputs(shape, dg, dtype, dev, seed=0, std=2.5, cout=None):
    """x, offsets (std ``std`` px), mask, weight, bias and cotangent at any
    width: C = shape[-1] channels in, ``cout`` (None: C) out, ``dg``
    groups."""
    b, h, w, c = shape
    cout = c if cout is None else cout
    g = _gen(seed)
    x = torch.randn(b, h, w, c, generator=g)
    off = torch.randn(b, h, w, dg * 18, generator=g) * std
    mask = torch.rand(b, h, w, dg * 9, generator=g)
    wgt = (torch.rand(cout, c, 3, 3, generator=g) * 2 - 1) / (9 * c) ** 0.5
    bias = torch.randn(cout, generator=g) * 0.1
    gout = torch.randn(b, h, w, cout, generator=g)
    return [t.to(dev, dtype) for t in (x, off, mask, wgt, bias, gout)]


# the widths beside (64, 8) and (16, 4): EDVR-L's 128 in 8 groups on the
# wgmma pair, and the narrow kernels' other cases (whole 8- and 4-channel
# groups, 6 channels a group: 2-element loads, 16 a group at 64)
OTHER_WIDTHS = [(128, 8), (32, 4), (32, 8), (48, 8), (64, 4)]


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_offset", [4, 8, None], ids=["r4", "r8",
                                                          "exact"])
@pytest.mark.parametrize("c,dg", OTHER_WIDTHS,
                         ids=[f"C{c}_dg{g}" for c, g in OTHER_WIDTHS])
def test_dcn_other_widths_match_plain(cuda, c, dg, max_offset, dtype, om):
    """The forward and backward at the other widths, both forms, on a
    ragged shape of several tiles, one launch each."""
    x, off, mask, wgt, bias, g = _width_inputs((2, 21, 45, c), dg, dtype,
                                               cuda, seed=c + dg)
    n = (dcn_fwd.launches, dcn_bwd.launches)
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, dg, act="lrelu",
                         max_offset=max_offset)
        ref = dcn_fwd_om_plain(x, t, wgt, bias, dg, "lrelu", max_offset)
        grads = dcn_bwd_om(x, t, wgt, g, dg, max_offset)
        grefs = dcn_bwd_om_plain(x, t, wgt, g, dg, max_offset)
        doff = grads[1][..., :dg * 18]
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, dg, act="lrelu",
                      max_offset=max_offset)
        ref = dcn_fwd_plain(x, off, mask, wgt, bias, dg, "lrelu", max_offset)
        grads = dcn_bwd(x, off, mask, wgt, g, dg, max_offset)
        grefs = dcn_bwd_plain(x, off, mask, wgt, g, dg, max_offset)
        doff = grads[1]
    torch.cuda.synchronize()
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1]) == (1, 1)
    assert out.shape == ref.shape and out.dtype == dtype
    assert max_abs_err(out, ref) <= tolerance(ref)
    for o, r in zip(grads, grefs):
        assert o.shape == r.shape and o.dtype == r.dtype
        assert max_abs_err(o, r) <= grad_tolerance(r)
    if max_offset is not None:
        assert not doff[off.abs() > max_offset].any()


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_fwd_128_many_tiles_per_block(cuda, dtype, om):
    """The 128-channel forward with ~3.5 tiles a block (456 tiles of 8 x 16
    over 132 SMs; ragged in H and W): its A-stage and weight rings wrap
    across tiles and the epilogue of one tile runs beside the next one's
    sampling."""
    x, off, mask, wgt, bias, _ = _width_inputs((3, 61, 300, 128), 8, dtype,
                                               cuda, seed=17)
    n = dcn_fwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, 8, act="relu", max_offset=4)
        ref = dcn_fwd_om_plain(x, t, wgt, bias, 8, "relu", 4)
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, 8, act="relu", max_offset=4)
        ref = dcn_fwd_plain(x, off, mask, wgt, bias, 8, "relu", 4)
    torch.cuda.synchronize()
    assert dcn_fwd.launches == n + 1
    assert out.shape == ref.shape and out.dtype == dtype
    assert max_abs_err(out, ref) <= tolerance(ref)


# the generalised dcn_narrow.cu over the TPU kernel's domain: (cin, cout,
# dg, mask): cin != cout both ways, 96 in 4 groups (24 a group: chunks of
# one group in the backward), 256 in 8 (the chunked backward, a 16-output
# forward tile), DCNv1 at the wgmma pair's widths, 400 -> 24 (the forward's
# weight streamed tap by tap), 6 -> 10 in 3 groups (2-element loads)
GENERAL_SHAPES = [(64, 32, 8, True), (64, 32, 8, False), (32, 64, 8, True),
                  (32, 64, 8, False), (96, 96, 4, True), (256, 256, 8, True),
                  (64, 64, 8, False), (128, 128, 8, False), (16, 16, 4, False),
                  (400, 24, 8, True), (6, 10, 3, True)]


# each shape in both forms, the in-place om only with a mask (it always
# carries one)
GENERAL_CASES = [(*shape, om) for shape in GENERAL_SHAPES
                 for om in ((False, True) if shape[3] else (False,))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_offset", [4, None], ids=["r4", "exact"])
@pytest.mark.parametrize(
    "cin,cout,dg,has_mask,om", GENERAL_CASES,
    ids=[f"{a}to{b}_dg{g}{'' if m else '_v1'}_{'om' if o else 'separate'}"
         for a, b, g, m, o in GENERAL_CASES])
def test_dcn_general_shapes_match_plain(cuda, cin, cout, dg, has_mask, om,
                                        max_offset, dtype):
    """The forward and backward of ``dcn_narrow.cu`` at cin != cout, wide
    inputs and no mask, both forms (the in-place ``om`` only with a mask),
    on a ragged shape of several runs, one launch each, against the plain
    versions with check.py's tolerances; with no mask there is no mask
    gradient."""
    x, off, mask, wgt, bias, g = _width_inputs((2, 13, 21, cin), dg, dtype,
                                               cuda, seed=cin + cout + dg,
                                               cout=cout)
    mask = mask if has_mask else None
    n = (dcn_fwd.launches, dcn_bwd.launches)
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, dg, act="lrelu",
                         max_offset=max_offset)
        ref = dcn_fwd_om_plain(x, t, wgt, bias, dg, "lrelu", max_offset)
        grads = dcn_bwd_om(x, t, wgt, g, dg, max_offset)
        grefs = dcn_bwd_om_plain(x, t, wgt, g, dg, max_offset)
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, dg, act="lrelu",
                      max_offset=max_offset)
        ref = dcn_fwd_plain(x, off, mask, wgt, bias, dg, "lrelu", max_offset)
        grads = dcn_bwd(x, off, mask, wgt, g, dg, max_offset)
        grefs = dcn_bwd_plain(x, off, mask, wgt, g, dg, max_offset)
    torch.cuda.synchronize()
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1]) == (1, 1)
    assert out.shape == ref.shape == (2, 13, 21, cout)
    assert max_abs_err(out, ref) <= tolerance(ref)
    for o, r in zip(grads, grefs):
        if r is None:
            assert o is None
            continue
        assert o.shape == r.shape and o.dtype == r.dtype
        assert max_abs_err(o, r) <= grad_tolerance(r)


# ragged cases of dcn_narrow.cu's tensor-core design: (name, (b, h, w),
# cin, cout, dg, mask): 6 channels a group (2-element loads, each step
# zero-padded to whole 32-byte chunks, N 64 for 40 outputs); 300 outputs (a
# second column block of 44, the backward's second g chunk); 512 inputs in
# 8 groups (the forward's weight streamed) and 256 in one group (a group
# in pieces of 64 across steps, its E sums carried; at 256 outputs its dW
# partials in a global scratch slot a block); a 1-pixel-wide image (tiles
# 1 pixel wide); a batch whose tiles outnumber the blocks many times
RAGGED_NARROW = [("24to40_dg4", (2, 13, 21), 24, 40, 4, True),
                 ("16to300_dg4", (1, 9, 11), 16, 300, 4, True),
                 ("512to64_dg8", (1, 9, 11), 512, 64, 8, True),
                 ("256to32_dg1", (1, 9, 11), 256, 32, 1, True),
                 ("256to256_dg1", (2, 13, 21), 256, 256, 1, True),
                 ("width1_16_dg4", (3, 37, 1), 16, 16, 4, True),
                 ("many_tiles_32_dg4_v1", (16, 64, 96), 32, 32, 4, False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name,pix,cin,cout,dg,has_mask", RAGGED_NARROW,
                         ids=[c[0] for c in RAGGED_NARROW])
def test_dcn_narrow_ragged_shapes_match_plain(cuda, name, pix, cin, cout, dg,
                                              has_mask, dtype):
    """``dcn_narrow.cu``'s forward and backward at its ragged cases
    (RAGGED_NARROW), each against the plain op with check.py's tolerances,
    ±4, one launch each way, the separate form (and DCNPack's in-place
    ``om`` where there is a mask, its gradient's offset part against the
    separate one's)."""
    x, off, mask, wgt, bias, g = _width_inputs((*pix, cin), dg, dtype, cuda,
                                               seed=cin + cout + dg,
                                               cout=cout)
    mask = mask if has_mask else None
    n = (dcn_fwd.launches, dcn_bwd.launches)
    out = dcn_fwd(x, off, mask, wgt, bias, dg, act="lrelu", max_offset=4)
    ref = dcn_fwd_plain(x, off, mask, wgt, bias, dg, "lrelu", 4)
    grads = dcn_bwd(x, off, mask, wgt, g, dg, 4)
    grefs = dcn_bwd_plain(x, off, mask, wgt, g, dg, 4)
    torch.cuda.synchronize()
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1]) == (1, 1)
    assert out.shape == ref.shape == (*pix, cout) and out.dtype == dtype
    assert max_abs_err(out, ref) <= tolerance(ref)
    for o, r in zip(grads, grefs):
        if r is None:
            assert o is None
            continue
        assert o.shape == r.shape and o.dtype == r.dtype
        assert max_abs_err(o, r) <= grad_tolerance(r)
    if has_mask:
        t = _om(off, mask)
        out_om = dcn_fwd_om(x, t, wgt, bias, dg, act="lrelu", max_offset=4)
        dx, dom, dw = dcn_bwd_om(x, t, wgt, g, dg, 4)
        torch.cuda.synchronize()
        assert max_abs_err(out_om, dcn_fwd_om_plain(x, t, wgt, bias, dg,
                                                    "lrelu", 4)) <= \
            tolerance(ref)
        assert max_abs_err(dom[..., :dg * 18], grads[1]) <= \
            grad_tolerance(grefs[1])
        assert max_abs_err(dx, grads[0]) <= grad_tolerance(grefs[0])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("padding", [1, 0], ids=["p1_kernel", "p0_columns"])
def test_deform_conv_module_on_card_matches_cpu(cuda, dtype, padding):
    """``DeformConvModule`` (DCNv1, external offsets) on the card: at 3x3 /
    p1 it launches ``dcn_narrow.cu`` each way, at p0 it runs the plain op
    (the columns a tap at a time) with no launch; forward and gradients
    against the CPU in f32."""
    from realvsr_tpu_torch.models.common import DeformConvModule

    mods = {dev: DeformConvModule(32, 48, 3, padding=padding,
                                  deformable_groups=4).to(dev)
            for dev in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(7)
    mods["cpu"].reset_parameters(gen)
    mods["cuda"].load_state_dict(mods["cpu"].state_dict())
    ho = 17 if padding else 15
    # inputs and weight rounded to the dtype first, for the CPU too: an
    # offset's rounding moves its sample and so its position gradient
    x = torch.randn(2, 17, 23, 32, generator=gen).to(dtype).float()
    off = (torch.randn(2, ho, 23 - 2 * (1 - padding), 4 * 18,
                       generator=gen) * 2).to(dtype).float()
    cot = torch.randn(2, ho, 23 - 2 * (1 - padding), 48, generator=gen)
    with torch.no_grad():
        mods["cpu"].weight.copy_(mods["cpu"].weight.to(dtype).float())
    res = {}
    for dev in ("cpu", "cuda"):
        dt = torch.float32 if dev == "cpu" else dtype
        xs = x.to(dev, dt).detach().requires_grad_()
        os_ = off.to(dev, dt).detach().requires_grad_()
        mod = mods[dev].to(dt)
        n = (dcn_fwd.launches, dcn_bwd.launches)
        y = mod(xs, os_)
        (y.float() * cot.to(dev)).sum().backward()
        if dev == "cuda":
            torch.cuda.synchronize()
            assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1]) == \
                ((1, 1) if padding else (0, 0))
        res[dev] = [t.detach().float().cpu() for t in
                    (y, xs.grad, os_.grad, mod.weight.grad)]
    tol = 5e-2 if dtype == torch.bfloat16 else 2e-3
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=tol * b.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("max_offset,std", [(None, 12.0), (12, 12.0),
                                            (8, 0.0)],
                         ids=["exact_far", "r12_far", "on_grid"])
def test_dcn_bwd_128_footprint_edges(cuda, dtype, max_offset, std):
    """The 128-channel backward with corners outside the dx footprint (no
    clamp, and a clamp wider than its radius of 8: the global path) and
    with every position on the grid (one-sided differences)."""
    x, off, mask, wgt, _, g = _width_inputs((1, 40, 72, 128), 8, dtype, cuda,
                                            seed=9, std=std)
    out = dcn_bwd(x, off, mask, wgt, g, 8, max_offset)
    ref = dcn_bwd_plain(x, off, mask, wgt, g, 8, max_offset)
    torch.cuda.synchronize()
    for o, r in zip(out, ref):
        assert max_abs_err(o, r) <= grad_tolerance(r)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_block_api_at_128_channels_matches_plain(cuda, dtype):
    """Kernel 5's API at EDVR-L's width, ±4, through kernel 1."""
    x, off, mask, wgt, bias, _ = _width_inputs((2, 33, 40, 128), 8, dtype,
                                               cuda, seed=3)
    n = (modulated_deform_conv_block.launches, dcn_fwd.launches)
    out = modulated_deform_conv_block(x, off, mask, wgt, bias,
                                      deformable_groups=8, max_offset=4)
    ref = modulated_deform_conv_plain(x, off, mask, wgt, bias, 1, 1, 1, 8, 4)
    torch.cuda.synchronize()
    assert (modulated_deform_conv_block.launches - n[0],
            dcn_fwd.launches - n[1]) == (1, 0)
    assert max_abs_err(out, ref) <= tolerance(ref)


def test_tsa_pools_backward_on_card_matches_cpu(cuda):
    """TSA's 3x3 / stride-2 max and average pools on NHWC tensors, forward
    and input gradient, card against CPU in f32 (on CUDA, avg_pool2d's
    backward of a channels-last view with these overlapping windows is
    wrong in torch 2.11: the helpers pool an NCHW copy)."""
    from realvsr_tpu_torch.models.common import (avg_pool_3x3_s2,
                                                 max_pool_3x3_s2)

    g = _gen(30)
    x = torch.randn(2, 16, 16, 128, generator=g)
    cot = torch.randn(2, 8, 8, 128, generator=g)
    for pool in (max_pool_3x3_s2, avg_pool_3x3_s2):
        outs = []
        for dev in ("cpu", cuda):
            leaf = x.to(dev).clone().requires_grad_()
            y = pool(leaf)
            (y * cot.to(dev)).sum().backward()
            outs.append((y.detach().cpu(), leaf.grad.cpu()))
        (y0, d0), (y1, d1) = outs
        assert torch.equal(y1, y0)
        torch.testing.assert_close(d1, d0, rtol=0,
                                   atol=1e-6 * d0.abs().max().item())


def test_streaming_matches_sliding_window_on_card(cuda):
    """Full width (nf 64, 8 groups), cut depth, bf16, 4 frames of 64 x 128:
    StreamingRunner.run against the sliding window of make_forward, within
    1e-2 of the output's largest magnitude (cuDNN's front convs may pick
    another algorithm for one frame than for a window of three)."""
    from realvsr_tpu_torch.eval.sliding_window import (make_forward,
                                                       sliding_window_infer)
    from realvsr_tpu_torch.eval.streaming import StreamingRunner
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    model = EDVRNoUp(nf=64, nframes=3, groups=8, front_RBs=1, back_RBs=1,
                     dcn_max_offset=4, device=cuda, dtype=torch.bfloat16,
                     generator=_gen(20))
    frames = np.random.default_rng(21).random((4, 64, 128, 3)).astype(
        np.float32)
    ref = np.stack([o for _, o in sliding_window_infer(
        make_forward(model), frames, 3, device=cuda)])
    runner = StreamingRunner(model, device=cuda)
    n = dcn_fwd.launches
    out = runner.run(frames).float().cpu().numpy()
    assert dcn_fwd.launches - n == 4 * 4
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    scan = runner.run_scan(frames).float().cpu().numpy()
    assert np.abs(scan - out).max() <= 1e-2 * np.abs(ref).max()


def test_batched_tiler_matches_loop_tiler_on_card(cuda):
    from realvsr_tpu_torch.eval.tiled import (make_batched_tiled_forward,
                                              make_tiled_forward)
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    model = EDVRNoUp(nf=64, nframes=3, groups=8, front_RBs=1, back_RBs=1,
                     dcn_max_offset=4, device=cuda, generator=_gen(22))
    window = torch.rand(3, 96, 160, 3, generator=_gen(23)).to(cuda)
    n = dcn_fwd.launches
    batched = make_batched_tiled_forward(model, tile_hw=(64, 96),
                                         overlap=16, device=cuda)(window)
    assert dcn_fwd.launches - n == 4      # one model call for every tile
    loop = make_tiled_forward(model, tile_hw=(64, 96), overlap=16,
                              device=cuda)(window)
    assert batched.shape == loop.shape == (96, 160, 3)
    assert (batched.cpu() - loop).abs().max() <= 2e-2 * loop.abs().max()


def test_lpips_and_niqe_on_card_match_cpu(cuda):
    from realvsr_tpu_torch.eval import niqe, perceptual

    rng = np.random.default_rng(24)
    x = rng.random((2, 64, 96, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    card = perceptual.lpips(perceptual.init_lpips_params(device=cuda), x, y)
    cpu = perceptual.lpips(perceptual.init_lpips_params(device="cpu"), x, y)
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=1e-3)
    img = np.clip(rng.normal(128, 40, (192, 192)), 0, 255)
    fc, kc = niqe.niqe_features(img, 48, 0.5, device=cuda)
    fh, kh = niqe.niqe_features(img, 48, 0.5, device="cpu")
    assert torch.equal(kc.cpu(), kh)
    np.testing.assert_allclose(fc.cpu().numpy(), fh.numpy(), rtol=1e-6)


def _recipe_opt(name, cuts=None):
    import os

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "train", name)) as f:
        opt = yaml.safe_load(f)
    opt["network_G"].update(cuts or {})
    return opt


def _within_spread(ref, got, noisy):
    """Each tensor of ``got`` within 5e-2 of the largest magnitude of its
    ``ref`` plus ``noisy``'s distance from ``ref`` (the CPU's own change
    under 2^-11 input noise).  The bias of a conv that feeds a BN
    (``<m>.conv{i}.bias`` beside ``<m>.bn{i}``) gets a zero gradient but
    for rounding: 5e-2 of its model's largest gradient there."""
    top = {m: max(r.abs().max().item() for k, r in ref.items()
                  if k.startswith(m) and "running" not in k)
           for m in {k.split(".")[0] for k in ref}}
    for k, r in ref.items():
        pre, _, leaf = k.rpartition(".")
        bn_fed = leaf == "bias" and pre.replace(".conv", ".bn") + ".weight" \
            in ref
        spread = (noisy[k] - r).abs().max().item()
        err = (got[k] - r).abs().max().item()
        scale = top[k.split(".")[0]] if bn_fed else r.abs().max().item()
        assert err <= 5e-2 * scale + spread, k


@pytest.mark.parametrize("recipe,cuts,counts", [
    ("train_TOF_RealVSR_YCbCr_Split.yml", dict(nb=1), (3, 1)),
    ("train_FSTRN_RealVSR_YCbCr_Split.yml", {}, (0, 0)),
    ("train_RCAN_RealVSR_YCbCr_Split.yml", dict(num_group=1, num_block=1),
     (4, 1)),
], ids=["TOF", "FSTRN", "RCAN"])
def test_tof_fstrn_rcan_train_steps_on_card_match_cpu(cuda, recipe, cuts,
                                                      counts):
    """``chip_smoke.py``'s card-vs-CPU Split steps of the new generators:
    the recipe's network at full width and cut depth (TOF nf 64, 1 ResBlock;
    FSTRN as given; RCAN 1 group of 1 RCAB), LQ 64x64, batch 2 of
    motion-synthetic frames, f32; loss to 1e-3 relative, each gradient to
    5e-2 of its largest plus the CPU's own change under 2^-11 input noise;
    the 64-out and other-width conv3x3 launches of the step (the backward
    runs cuDNN; FSTRN's 3-D convs are all cuDNN)."""
    from realvsr_tpu_torch.data.synthetic import SyntheticMotionVSRDataset
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    opt = _recipe_opt(recipe, cuts)
    opt.pop("augment")
    net = opt["network_G"]
    ds = SyntheticMotionVSRDataset(dict(
        N_frames=net.get("nframes") or net["num_frames"], GT_size=64,
        scale=1, frame_h=96, frame_w=96))
    items = [ds.get(i, np.random.default_rng(i)) for i in (3, 17)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}
    ref = define_g(opt, device="cpu", generator=_gen(12))

    def step(dev, b):
        model = define_g(opt, device=dev)
        model.load_state_dict(ref.state_dict())
        _, logs = make_split_train_step(model, opt)(
            create_train_state(model, opt),
            {k: v.to(dev) for k, v in b.items()},
            torch.Generator(device=dev))
        return logs["l_pix"].item(), {f"G.{k}": p.grad.float().cpu()
                                      for k, p in model.named_parameters()}

    loss, grads = step("cpu", batch)
    n = (conv3x3.launches, conv3x3_fused.launches)
    card_loss, card = step(cuda, batch)
    assert (conv3x3.launches - n[0], conv3x3_fused.launches - n[1]) \
        == counts
    assert card_loss == pytest.approx(loss, rel=1e-3)
    lq = batch["LQs"]
    _, noisy = step("cpu", dict(batch, LQs=lq * (1 + 2.0 ** -11 * torch.randn(
        lq.shape, generator=_gen(16)))))
    _within_spread(grads, card, noisy)


def test_gan_step_on_card_matches_cpu(cuda):
    """``chip_smoke.py``'s card-vs-CPU GAN-Split step: the GAN recipe's G
    (EDVR_NoUp, nf 64, 8 groups, 5 + 10 ResBlocks, offset convs randomised)
    and D (MultiscaleDiscriminator_v4, nf 64) on a Synthetic batch of 2 at
    64x64, f32, augmentation off: losses to 1e-3 relative; each gradient of
    G and D and each of D's running statistics after the step to 5e-2 of
    its largest plus the CPU's own change under 2^-11 input noise; the
    Split step's kernel launches (D runs none)."""
    from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset
    from realvsr_tpu_torch.models import define_d, define_g
    from realvsr_tpu_torch.train.gan import (create_gan_train_state,
                                             make_gan_split_train_step)

    opt = _recipe_opt("train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml")
    opt["augment"] = None
    ref_g = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    g = _gen(13)
    with torch.no_grad():
        for pname, p in ref_g.named_parameters():
            if "conv_offset_mask" in pname:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    ref_d = define_d(opt, device="cpu", generator=_gen(14))
    ds = SyntheticVSRDataset(dict(N_frames=3, GT_size=64))
    items = [ds.get(i, np.random.default_rng(i)) for i in (3, 17)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}

    def step(dev, b):
        gm = define_g(opt, device=dev, dcn_max_offset=8)
        gm.load_state_dict(ref_g.state_dict())
        dm = define_d(opt, device=dev)
        dm.load_state_dict(ref_d.state_dict())
        _, logs = make_gan_split_train_step(gm, opt)(
            create_gan_train_state(gm, dm, opt),
            {k: v.to(dev) for k, v in b.items()},
            torch.Generator(device=dev))
        vals = {f"G.{k}": p.grad for k, p in gm.named_parameters()}
        vals.update({f"D.{k}": p.grad for k, p in dm.named_parameters()})
        vals.update({f"D.{k}": t for k, t in dm.named_buffers()
                     if "running" in k})
        return ({k: logs[k].item() for k in ("l_g_total", "l_d_real",
                                             "l_d_fake")},
                {k: v.float().cpu() for k, v in vals.items()})

    losses, ref = step("cpu", batch)
    n = (dcn_fwd.launches, dcn_bwd.launches, conv3x3.launches,
         conv3x3_fused.launches)
    card_losses, card = step(cuda, batch)
    assert (dcn_fwd.launches - n[0], dcn_bwd.launches - n[1],
            conv3x3.launches - n[2], conv3x3_fused.launches - n[3]) \
        == (4, 4, 45, 5)
    for k, v in losses.items():
        assert card_losses[k] == pytest.approx(v, rel=1e-3), k
    lq = batch["LQs"]
    _, noisy = step("cpu", dict(batch, LQs=lq * (1 + 2.0 ** -11 * torch.randn(
        lq.shape, generator=_gen(16)))))
    _within_spread(ref, card, noisy)


def test_two_rank_split_step_on_card_matches_one_process(cuda, tmp_path):
    """Two ``gloo`` ranks sharing the card (``tests/torch_parallel_worker.py``)
    take one Split step of EDVRNoUp (nf 16, 4 groups: the narrow DCN
    kernels; 1 + 1 ResBlocks; ±8) on their halves of a global batch of 4 at
    48x48: their parameters are bit-identical, and their averaged gradients
    equal one process's on the card within 1e-3 of each tensor's largest
    plus twice that process's own change when the batch is reordered (the
    same kernels; sums in another order: against one process alone,
    ``conv_first``'s small gradient came 6e-3 of its largest apart)."""
    from torch_parallel_worker import launch, wait

    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_train_step

    opt = _recipe_opt("train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")
    opt["augment"] = None
    opt["network_G"].update(nf=16, groups=4, front_RBs=1, back_RBs=1)
    ref = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(0))
    g = _gen(1)
    with torch.no_grad():
        for pname, p in ref.named_parameters():
            if "conv_offset_mask" in pname:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5)
    torch.save({"G": ref.state_dict()}, tmp_path / "init.pt")
    rng = np.random.default_rng(2)
    batch = {k: rng.random((4, 3, 48, 48, 3)).astype(np.float32)
             for k in ("LQs", "GT")}
    np.savez(tmp_path / "batch.npz", **batch)
    procs = launch(tmp_path, "step", dict(
        opt=opt, init=str(tmp_path / "init.pt"), max_offset=8,
        batch=str(tmp_path / "batch.npz"), out=str(tmp_path / "step"),
        device="cuda"))
    wait(procs)
    def one_process(order):
        model = define_g(opt, device=cuda, dcn_max_offset=8)
        model.load_state_dict(ref.state_dict())
        make_train_step(model, opt)(create_train_state(model, opt),
                                    {k: torch.from_numpy(v[order]).to(cuda)
                                     for k, v in batch.items()},
                                    torch.Generator(device=cuda))
        return {k: p.grad.float().cpu() for k, p in model.named_parameters()}

    one, reordered = one_process([0, 1, 2, 3]), one_process([2, 3, 0, 1])
    ranks = [torch.load(tmp_path / f"step.{r}.pt") for r in range(2)]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    for k, g in one.items():
        err = (ranks[0]["grads"][f"G.{k}"] - g).abs().max().item()
        spread = (reordered[k] - g).abs().max().item()
        assert err <= (1e-3 * g.abs().max().clamp_min(1e-30).item()
                       + 2 * spread), k


def test_shard_forward_on_card_matches_unsharded(cuda):
    """``eval/spatial.py::shard_forward`` of EDVRNoUp (nf 16, 1 + 1
    ResBlocks, offsets randomised, clamped to ±4) in 4 shards on the card,
    default halo (104 rows), against the unsharded forward: within 1e-3
    of the output's largest (f32; cuDNN's strided convs may pick other
    algorithms for the shard windows)."""
    from realvsr_tpu_torch.eval.spatial import default_halo, shard_forward
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    model = EDVRNoUp(nf=16, nc=3, nframes=3, groups=4, front_RBs=1,
                     back_RBs=1, w_TSA=False, dcn_max_offset=4, device=cuda,
                     generator=_gen(0)).eval()
    g = _gen(1)
    with torch.no_grad():
        for pname, p in model.named_parameters():
            if "conv_offset_mask" in pname:
                p.copy_(torch.randn(p.shape, generator=g).to(cuda) * 0.5)
    x = torch.rand(1, 3, 416, 64, 3, generator=_gen(2)).to(cuda)
    halo = default_halo(model)
    with torch.inference_mode():
        full = model(x)
        out = torch.cat([shard_forward(model, x, i, 4, halo)
                         for i in range(4)], 1)
    assert out.shape == full.shape
    assert (out - full).abs().max().item() <= 1e-3 * full.abs().max().item()


def test_degradation_on_card_matches_cpu(cuda):
    """``ops/degradation.py`` and ``ops/resize.py::matlab_imresize`` on the
    card against the CPU: SRMD (x2, l = 21, noise off) from the same kernel
    draws and the bicubic at 1/3, within 1e-5 (f32, TF32 off)."""
    from realvsr_tpu_torch.ops.degradation import (SRMDPreprocessing,
                                                   pca_fit,
                                                   random_batch_kernel)
    from realvsr_tpu_torch.ops.resize import matlab_imresize

    basis = pca_fit(random_batch_kernel(np.random.default_rng(0), 64)
                    .reshape(64, -1), k=10)
    srmd = SRMDPreprocessing(2, basis, noise=False)
    hr = torch.rand(4, 48, 40, 3, generator=_gen(1))
    cpu = srmd(np.random.default_rng(2), torch.Generator(), hr)
    card = srmd(np.random.default_rng(2), torch.Generator(device=cuda),
                hr.to(cuda))
    for a, b in zip(card, cpu):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=0)
    torch.testing.assert_close(matlab_imresize(hr.to(cuda), 1 / 3).cpu(),
                               matlab_imresize(hr, 1 / 3), atol=1e-5, rtol=0)


def _card_vs_cpu_grad(fn, x, cot, cuda):
    """(output, input gradient) of ``fn`` on the CPU and on the card, for
    the same NHWC input ``x`` and output cotangent ``cot``."""
    outs = []
    for dev in ("cpu", cuda):
        leaf = x.to(dev).clone().requires_grad_()
        y = fn(leaf, dev)
        (y * cot.to(dev)).sum().backward()
        outs.append((y.detach().cpu(), leaf.grad.cpu()))
    return outs


def test_v2_discriminator_pool_backward_on_card_matches_cpu(cuda):
    """MultiscaleDiscriminator_v2's 3x3 / stride 2 / pad 1 average pool
    (count_include_pad=False), which pools a channels-last view of an NHWC
    tensor with overlapping windows (the pattern of torch 2.11's CUDA
    avg_pool2d backward fault, see the TSA test above): forward and input
    gradient, card against CPU in f32."""
    from realvsr_tpu_torch.models.discriminators import (
        _avg_pool_3x3_s2_nopad_count)

    g = _gen(31)
    for shape in ((2, 16, 16, 128), (4, 33, 47, 3)):
        b, h, w, c = shape
        x = torch.randn(*shape, generator=g)
        cot = torch.randn(b, (h + 1) // 2, (w + 1) // 2, c, generator=g)
        (y0, d0), (y1, d1) = _card_vs_cpu_grad(
            lambda t, dev: _avg_pool_3x3_s2_nopad_count(t), x, cot, cuda)
        torch.testing.assert_close(y1, y0, rtol=0, atol=1e-6)
        torch.testing.assert_close(d1, d0, rtol=0,
                                   atol=1e-6 * d0.abs().max().item())


def _v2_input_grad(monkeypatch, dev, dtype, train, x, cots, slopes=None):
    """(the input gradient of a MultiscaleDiscriminator_v2 (3 PatchGANs, nf
    64, seed 5) in ``dtype`` on ``dev`` for output cotangents ``cots``,
    each of its LeakyReLU(0.2) inputs), float64 on the CPU.  With
    ``slopes`` (another run's LeakyReLU inputs) each LeakyReLU takes its
    slope from the sign of that run's input instead of its own."""
    from realvsr_tpu_torch.models import discriminators

    pre = []

    def lrelu(t):
        if slopes is None:
            y = F.leaky_relu(t, 0.2)
        else:
            y = torch.where(slopes[len(pre)].to(t.device) > 0, t, 0.2 * t)
        pre.append(t.detach().cpu().double())
        return y

    monkeypatch.setattr(discriminators, "_lrelu2", lrelu)
    net = discriminators.MultiscaleDiscriminatorV2(
        3, 64, num_D=3, device=dev, dtype=dtype,
        generator=torch.Generator().manual_seed(5)).to(dtype)
    net.train(train)
    leaf = x.to(dev, dtype).clone().requires_grad_()
    outs = net(leaf)
    sum((o * c.to(dev, dtype)).sum() for o, c in zip(outs, cots)).backward()
    return leaf.grad.cpu().double(), pre


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_v2_discriminator_input_grad_on_card_matches_cpu(cuda, monkeypatch,
                                                         mode):
    """A whole MultiscaleDiscriminator_v2 (on the pool cascade), in train
    mode as a GAN step runs it and in eval mode: the gradient of its
    outputs w.r.t. its NHWC input on the card, against the CPU's float64,
    as a share of the largest element.

    * float64 on the card: within 1e-9 (H100 readings 2.2e-15 train,
      1.5e-15 eval).  With the pool fault the f32 card was 45% off; this
      bound holds any card fault above float64 rounding.
    * f32 (cuDNN without TF32), on the card and on the CPU: a LeakyReLU
      input that rounds to the other side of 0 changes its slope by 0.8,
      and one such flip moves this gradient by up to ~1e-2 of its largest
      (readings: the card flips one input in train mode and is 9.2e-3
      off, the CPU one in eval mode and is 2.5e-3 off; without a flip
      both are within 3.3e-6).  So each f32 run is held against the
      float64 run that takes its slopes from the f32 run's LeakyReLU
      inputs, within 2e-5 (readings 7.0e-7 to 3.2e-6); its LeakyReLU
      inputs within 5e-5 of float64's, layer by layer, as a share of the
      layer's largest (readings 2.6e-6 to 8.3e-6); and a flip only at an
      input within that of 0.  Card against CPU, as they come, within the
      GAN step's card-vs-CPU bound, 5e-2 of the largest (``chip_smoke.py``
      phase 8)."""
    train = mode == "train"
    g = _gen(32)
    x = torch.rand(2, 64, 64, 3, generator=g)
    cots = [torch.randn(2, s, s, 1, generator=g) for s in (16, 8, 4)]
    exact, pre64 = _v2_input_grad(monkeypatch, "cpu", torch.float64, train,
                                  x, cots)
    largest = exact.abs().max().item()
    card64, _ = _v2_input_grad(monkeypatch, cuda, torch.float64, train, x,
                               cots)
    readings = {"card float64": (card64 - exact).abs().max().item()
                / largest}
    f32 = {}
    for dev in ("cpu", cuda):
        d, pre = _v2_input_grad(monkeypatch, dev, torch.float32, train, x,
                                cots)
        pinned, _ = _v2_input_grad(monkeypatch, "cpu", torch.float64, train,
                                   x, cots, slopes=pre)
        name = f"{torch.device(dev).type} f32"
        f32[name] = d
        readings[name] = (d - exact).abs().max().item() / largest
        readings[f"{name} on its slopes"] = ((d - pinned).abs().max().item()
                                             / largest)
        flips, worst = 0, 0.0
        for a, b in zip(pre, pre64):
            scale = b.abs().max().item()
            worst = max(worst, (a - b).abs().max().item() / scale)
            flip = (a > 0) != (b > 0)
            flips += int(flip.sum())
            assert (b[flip].abs() <= 5e-5 * scale).all(), name
        readings[f"{name} LeakyReLU inputs"] = worst
        readings[f"{name} flips"] = flips
    print(f"v2 D input gradient, {mode}: largest {largest}, {readings}")
    assert readings["card float64"] <= 1e-9
    for name in ("cpu f32", "cuda f32"):
        assert readings[f"{name} on its slopes"] <= 2e-5, name
        assert readings[f"{name} LeakyReLU inputs"] <= 5e-5, name
    assert (f32["cuda f32"] - f32["cpu f32"]).abs().max().item() <= \
        5e-2 * largest


@pytest.mark.parametrize("which", ["ssim_downsample", "ms_ssim"])
def test_ssim_pools_backward_on_card_matches_cpu(cuda, which):
    """The SSIM losses' average pools of channels-last views (ssim_value's
    downsample above ~384 px, MS-SSIM's 2x2 pools; windows that do not
    overlap): the loss's input gradient, card against CPU in f32."""
    from realvsr_tpu_torch.losses.ssim import ms_ssim_value, ssim_value

    g = _gen(33)
    side = 512 if which == "ssim_downsample" else 192
    x = torch.rand(2, side, side, 3, generator=g)
    ref = torch.rand(2, side, side, 3, generator=g)
    fn = ssim_value if which == "ssim_downsample" else ms_ssim_value
    (y0, d0), (y1, d1) = _card_vs_cpu_grad(
        lambda t, dev: fn(t, ref.to(dev)), x, torch.ones(2), cuda)
    torch.testing.assert_close(y1, y0, rtol=0, atol=1e-5)
    torch.testing.assert_close(d1, d0, rtol=0,
                               atol=1e-4 * d0.abs().max().item())


def test_flagship_window_kernel_spans_match_the_launch_counters(cuda):
    """One flagship window (EDVR_NoUp at its published widths and depth,
    bf16) through the restore entry under torch.profiler: its
    ``kernel.conv3x3`` and ``kernel.dcn_fwd`` spans equal the launch
    counters' deltas over the window, the frame's restore spans are there
    once each, and each restore span agrees with the profiler's event of
    it within 50 us at both ends (the median over the spans)."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from realvsr_tpu_torch.eval.sliding_window import (make_forward,
                                                       sliding_window_infer)
    from realvsr_tpu_torch.models.edvr import EDVRNoUp
    from realvsr_tpu_torch.utils import trace

    model = EDVRNoUp(nf=64, nframes=3, groups=8, front_RBs=5, back_RBs=10,
                     w_TSA=False, dcn_max_offset=4, device=cuda,
                     dtype=torch.bfloat16)
    fwd = make_forward(model)
    clip = torch.rand(3, 64, 128, 3, generator=_gen(40)).numpy()
    next(sliding_window_infer(fwd, clip, 3, device=cuda))   # warm-up
    trace.clear()
    n = (conv3x3.launches + conv3x3_fused.launches, dcn_fwd.launches)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        idx, out = next(sliding_window_infer(fwd, clip, 3, device=cuda))
    torch.cuda.synchronize()
    delta = (conv3x3.launches + conv3x3_fused.launches - n[0],
             dcn_fwd.launches - n[1])
    spans = trace.spans()
    got = (sum(s.name == "kernel.conv3x3" for s in spans),
           sum(s.name == "kernel.dcn_fwd" for s in spans))
    print(f"kernel spans {got}, launch counter deltas {delta}")
    assert got == delta and delta[0] > 0 and delta[1] == 4
    assert idx == 0 and out.shape == (64, 128, 3)
    phases = [s for s in spans if s.name.startswith("restore.")]
    assert sorted(s.name for s in phases) == [
        "restore.download", "restore.forward", "restore.gather",
        "restore.upload", "restore.wait"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("restore.")
              and "CUDA" not in str(e.device_type())}
    gaps = [(abs(events[s.name].start_ns() - s.start_ns),
             abs(events[s.name].start_ns() + events[s.name].duration_ns()
                 - s.end_ns)) for s in phases]
    print(f"restore spans against the profiler's events, ns: {gaps}")
    assert statistics.median(g[0] for g in gaps) < 50_000
    assert statistics.median(g[1] for g in gaps) < 50_000
    trace.clear()


def _restore_model(cuda):
    """The flagship at its widths, cut depth, bf16, and a 6-frame clip of
    64 x 128."""
    from realvsr_tpu_torch.eval.sliding_window import make_forward
    from realvsr_tpu_torch.models.edvr import EDVRNoUp

    model = EDVRNoUp(nf=64, nframes=3, groups=8, front_RBs=1, back_RBs=1,
                     dcn_max_offset=4, device=cuda, dtype=torch.bfloat16,
                     generator=_gen(50))
    frames = np.random.default_rng(51).random((6, 64, 128, 3)).astype(
        np.float32)
    return make_forward(model), frames


def _synchronous_frames(fwd, frames, cuda):
    """Frame by frame, each output cast, waited for and copied to pageable
    host memory before the next window runs."""
    from realvsr_tpu_torch.utils.indexing import index_generation

    clip = torch.from_numpy(frames).to(cuda)
    out = []
    for t in range(frames.shape[0]):
        window = clip[index_generation(t, frames.shape[0], 3,
                                       padding="replicate")]
        y = fwd(window).float()
        torch.cuda.synchronize()
        out.append(y.cpu().numpy())
    return out


def test_run_ahead_restore_equals_the_synchronous_frames(cuda):
    """The restore entry (pinned downloads, one window ahead) against the
    synchronous loop on a short bf16 clip: bit for bit where two
    synchronous runs agree bit for bit (deterministic kernels), else within
    the restore cells' frame gap (0.05 of the residual's rms)."""
    from realvsr_tpu_torch.eval.sliding_window import sliding_window_infer

    fwd, frames = _restore_model(cuda)
    ref = _synchronous_frames(fwd, frames, cuda)
    again = _synchronous_frames(fwd, frames, cuda)
    got = list(sliding_window_infer(fwd, frames, 3, device=cuda))
    assert [i for i, _ in got] == list(range(frames.shape[0]))
    exact = all(np.array_equal(a, b) for a, b in zip(ref, again))
    for (_, g), r, x in zip(got, ref, frames):
        assert g.dtype == np.float32 and g.shape == r.shape
        gap = np.sqrt(np.mean((g - r) ** 2)) / np.sqrt(np.mean((r - x) ** 2))
        print(f"deterministic {exact}, max abs diff {np.abs(g - r).max()}, "
              f"gap {gap}")
        assert np.array_equal(g, r) if exact else gap <= 0.05


def test_run_ahead_frames_are_pinned_and_stay_intact(cuda):
    """Each frame handed back lies on its own pinned tensor and does not
    change while three more frames are handed back."""
    from realvsr_tpu_torch.eval.sliding_window import sliding_window_infer

    fwd, frames = _restore_model(cuda)
    kept, copies = [], []
    for _, out in sliding_window_infer(fwd, frames, 3, device=cuda):
        assert isinstance(out.base, torch.Tensor) and out.base.is_pinned()
        assert not any(np.shares_memory(out, k) for k in kept)
        kept.append(out)
        copies.append(out.copy())
        if len(kept) >= 4:
            assert np.array_equal(kept[-4], copies[-4])
    assert all(np.array_equal(a, b) for a, b in zip(kept, copies))


def test_run_ahead_gather_and_forward_never_wait_on_the_host(cuda):
    """A profiled frame past the second (the third ask, which gathers and
    launches the fourth window): no synchronize call and no blocking
    ``cudaMemcpy`` inside that window's ``restore.gather`` or
    ``restore.forward``, which launch kernels; the frame's own wait is an
    event's synchronize."""
    from torch.profiler import ProfilerActivity, profile

    from realvsr_tpu_torch.eval.sliding_window import sliding_window_infer
    from realvsr_tpu_torch.utils import trace

    fwd, frames = _restore_model(cuda)
    it = sliding_window_infer(fwd, frames, 3, device=cuda)
    next(it)
    next(it)
    trace.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        idx, _ = next(it)
    it.close()
    assert idx == 2
    spans = {s.name: s for s in trace.spans() if s.req[1:] == (3,)
             and s.name in ("restore.gather", "restore.forward")}
    waits = trace.spans("restore.wait")
    assert spans.keys() == {"restore.gather", "restore.forward"}
    calls = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("cuda", "cu"))
             and "CUDA" not in str(e.device_type())]
    inside = {n: [c for c, a, b in calls
                  if s.start_ns <= a and b <= s.end_ns]
              for n, s in spans.items()}
    print({n: sorted(set(c)) for n, c in inside.items()})
    assert any("Launch" in c for c in inside["restore.forward"])
    for n, c in inside.items():
        bad = [x for x in c if "Synchronize" in x or x == "cudaMemcpy"]
        assert not bad, (n, bad)
    (w,) = waits
    assert any(c == "cudaEventSynchronize" and w.start_ns <= a
               and b <= w.end_ns for c, a, b in calls)
    trace.clear()


# ---- BasicVSR++ (models/basicvsr_pp.py, eval/recurrent.py) ----------------

def _basicvsrpp(dev, mid=64, num_blocks=2, seed=3):
    """BasicVSR++ at the published width (``mid``) with fewer blocks, on
    the benchmark cell's seeded weights and gains (``portbench/``)."""
    import json

    from portbench.drivers.restore_recurrent import make_weights
    from realvsr_tpu_torch.models import define_g

    net = dict(which_model_G="BasicVSRPlusPlus", mid_channels=mid,
               num_blocks=num_blocks, max_residue_magnitude=10,
               is_low_res_input=True)
    with open("portbench/configs/basicvsrpp.json") as f:
        params = make_weights(json.load(f), seed, "cpu", torch.float32, net)
    model = define_g({"network_G": net, "scale": 4}, device=dev)
    model.load_state_dict(params, strict=True)
    return model


def test_basicvsrpp_on_card_matches_cpu_with_large_flows(cuda):
    """The CUDA model (f32: the conv and DCN kernels in TF32, cuDNN's
    SPyNet and ``grid_sample``) against the port's plain CPU path, 5 frames
    at 64x96.  SPyNet's flows card vs CPU first; then both propagate the
    same flows scaled to ~12 px rms (to 45 px: exact offsets whose corners
    fall far outside a DCN tile) and reconstruct every frame.  Tolerance:
    0.5% of each frame's residual rms (the card reads ~0.1%: TF32's ~1e-3
    a conv carried through the four branches' recurrence); an offset
    misplaced by a pixel reads ~O(1)."""
    from realvsr_tpu_torch.models.basicvsr_pp import BRANCHES
    from realvsr_tpu_torch.ops.resize import resize_bilinear

    models = {"cpu": _basicvsrpp("cpu"), "cuda": _basicvsrpp(cuda)}
    x = torch.rand(1, 5, 64, 96, 3, generator=_gen(7))
    n = dcn_fwd.launches
    with torch.no_grad():
        fwd, bwd = models["cpu"].compute_flow(x)
        fwd_c, bwd_c = models["cuda"].compute_flow(x.to(cuda))
        for a, b in ((fwd, fwd_c), (bwd, bwd_c)):
            assert max_abs_err(b.cpu(), a) <= 1e-3 * max(1.0, a.abs().max())
        s = 12.0 / bwd.pow(2).mean().sqrt()
        fwd, bwd = fwd * s, bwd * s
        print(f"flow rms {bwd.pow(2).mean().sqrt():.2f} max "
              f"{bwd.abs().max():.2f}")
        out = {}
        for dev, m in models.items():
            lqs = x.to(dev)
            feats = {"spatial": m.extract(lqs)}
            for br in BRANCHES:
                flows = bwd if br.startswith("backward") else fwd
                m.propagate(feats, flows.to(dev), br)
            out[dev] = torch.stack([m.reconstruct(lqs[:, t], feats, t)
                                    for t in range(5)], 1).cpu()
    torch.cuda.synchronize()
    assert dcn_fwd.launches - n == 4 * 4
    base = resize_bilinear(x[0], (256, 384))
    for t in range(5):
        res = (out["cpu"][0, t] - base[t]).pow(2).mean().sqrt()
        gap = (out["cuda"][0, t] - out["cpu"][0, t]).pow(2).mean().sqrt()
        print(f"frame {t}: gap {gap / res:.2e}")
        assert gap <= 0.005 * res, t


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_at_basicvsrpp_alignment_exact_offsets(cuda, dtype, om):
    """BasicVSR++'s alignment DCN on ``dcn_narrow.cu`` at its deployed
    shape, (1, 180, 320) 128 -> 64 in 16 groups, exact offsets of flow
    magnitude (a translation of (13.5, -17.25) px plus 4 px rms: corners
    far outside a tile, many outside the frame), against the plain op."""
    x, off, mask, wgt, bias, _ = _width_inputs((1, 180, 320, 128), 16,
                                               dtype, cuda, seed=20, std=4.0,
                                               cout=64)
    off = (off.float() + torch.tensor([13.5, -17.25], device=cuda).repeat(
        16 * 9)).to(dtype)
    n = dcn_fwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, 16)
        ref = dcn_fwd_om_plain(x, t, wgt, bias, 16)
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, 16)
        ref = dcn_fwd_plain(x, off, mask, wgt, bias, 16)
    torch.cuda.synchronize()
    assert dcn_fwd.launches - n == 1
    assert out.shape == ref.shape == (1, 180, 320, 64)
    assert max_abs_err(out, ref) <= tolerance(ref)


def test_recurrent_restore_never_waits_on_the_host_while_propagating(cuda):
    """The recurrent entry's first ask of a second clip, profiled: no
    synchronize call and no blocking ``cudaMemcpy`` inside
    ``restore.extract``, ``restore.flow`` or ``restore.propagate`` (the
    host launches the whole clip's propagation ahead of the device); the
    frames equal the model's whole-clip forward (bf16, deterministic
    kernels: within the restore cells' 0.05 of the residual otherwise)."""
    from torch.profiler import ProfilerActivity, profile

    from realvsr_tpu_torch.eval.recurrent import recurrent_infer
    from realvsr_tpu_torch.utils import trace

    model = _basicvsrpp(cuda, num_blocks=1)
    model.dtype = torch.bfloat16
    model.to(torch.bfloat16)
    frames = torch.rand(4, 64, 64, 3, generator=_gen(9)).numpy()
    with torch.inference_mode():
        want = model(torch.from_numpy(frames).to(cuda)[None]).float().cpu()
    first = list(recurrent_infer(model, frames, cuda))    # warm-up
    trace.clear()
    it = recurrent_infer(model, frames, cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0, _ = next(it)
    it.close()
    assert t0 == 0
    spans = [s for s in trace.spans() if s.name in (
        "restore.extract", "restore.flow", "restore.propagate")]
    assert len(spans) == 6
    calls = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("cuda", "cu"))
             and "CUDA" not in str(e.device_type())]
    for s in spans:
        inside = [c for c, a, b in calls if s.start_ns <= a and b <= s.end_ns]
        bad = [c for c in inside if "Synchronize" in c or c == "cudaMemcpy"]
        assert any("Launch" in c for c in inside), s.name
        assert not bad, (s.name, s.attrs, bad)
    trace.clear()
    for t, got in first:
        w = want[0, t].numpy()
        base = _resize_bilinear_np(frames[t], 4)
        gap = np.sqrt(np.mean((got - w) ** 2)) / np.sqrt(np.mean(
            (w - base) ** 2))
        print(f"frame {t}: max abs diff {np.abs(got - w).max()}, gap {gap}")
        assert gap <= 0.05


def _graph_counts(model, frames, cuda):
    """(the clip's restored frames, ``restore.graph``'s samples), the
    restore profiled so the counter records."""
    from torch.profiler import ProfilerActivity, profile

    from realvsr_tpu_torch.eval.recurrent import recurrent_infer
    from realvsr_tpu_torch.utils import trace

    trace.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = [f for _, f in recurrent_infer(model, frames, cuda)]
    counts = [c.value for c in trace.counters("restore.graph")]
    trace.clear()
    return out, counts


def _eager(model, frames, cuda):
    """The clip through the model's ``forward`` (every step eager)."""
    with torch.inference_mode():
        out = model(torch.from_numpy(frames).to(cuda)[None])
    return [f.float().cpu().numpy() for f in out[0]]


def test_recurrent_graphs_match_the_eager_restore(cuda):
    """The restore entry's branch steps replayed from CUDA graphs against
    the same clip through ``forward``, every step eager (bf16, the
    published width): the frames are bit-identical, the same kernels on
    the same inputs.  A clip's first restore captures each branch at its
    third step; a second restore of the size replays from the third step
    on; a second size captures anew and keeps the first's."""
    from realvsr_tpu_torch.eval.recurrent import graphs

    model = _basicvsrpp(cuda, num_blocks=1).to(torch.bfloat16)
    model.dtype = torch.bfloat16
    runner = graphs(model)
    for h, w in ((64, 64), (64, 96)):
        frames = torch.rand(5, h, w, 3, generator=_gen(h + w)).numpy()
        want = _eager(model, frames, cuda)
        for n, per_branch in ((1, [0, 0, 0, 1, 1]), (2, [0, 0, 1, 1, 1])):
            got, counts = _graph_counts(model, frames, cuda)
            assert counts == 4 * per_branch, (h, w, n)
            for t, (g, e) in enumerate(zip(got, want)):
                assert np.array_equal(g, e), (h, w, n, t,
                                              np.abs(g - e).max())
    assert [s[1:3] for s in runner.sizes] == [(64, 64), (64, 96)]
    assert all(len(group) == 4 for _, group in runner.sizes.values())


def test_recurrent_two_frame_clip_runs_eagerly(cuda):
    """A clip of two frames has no second-order step: every step runs
    eagerly, nothing is captured, and the frames equal ``forward``'s."""
    from realvsr_tpu_torch.eval.recurrent import graphs

    model = _basicvsrpp(cuda, num_blocks=1).to(torch.bfloat16)
    model.dtype = torch.bfloat16
    frames = torch.rand(2, 64, 80, 3, generator=_gen(3)).numpy()
    got, counts = _graph_counts(model, frames, cuda)
    assert counts == [0] * 8
    assert not graphs(model).sizes
    for g, e in zip(got, _eager(model, frames, cuda)):
        assert np.array_equal(g, e)


def test_recurrent_graph_counter_mean_and_kept_sizes(cuda):
    """``restore.graph``'s mean over a 12-frame clip after its size's
    captures: (12 - 2) / 12 a branch, the first two steps eager.  Past
    ``MAX_SIZES`` clip sizes the least recently used size's captures are
    dropped, and a restore of it captures them again."""
    from realvsr_tpu_torch.eval import recurrent

    model = _basicvsrpp(cuda, num_blocks=1).to(torch.bfloat16)
    model.dtype = torch.bfloat16
    runner = recurrent.graphs(model)
    frames = torch.rand(12, 64, 64, 3, generator=_gen(4)).numpy()
    _graph_counts(model, frames, cuda)
    _, counts = _graph_counts(model, frames, cuda)
    assert len(counts) == 48 and np.mean(counts) == pytest.approx(10 / 12)
    widths = [80 + 16 * i for i in range(recurrent.MAX_SIZES)]
    for w in widths:           # the last of them drops 64's captures
        clip = torch.rand(3, 64, w, 3, generator=_gen(w)).numpy()
        _, counts = _graph_counts(model, clip, cuda)
        assert counts == 4 * [0, 0, 0]
    assert [s[2] for s in runner.sizes] == widths
    _, counts = _graph_counts(model, frames, cuda)
    assert counts == 4 * ([0, 0, 0] + [1] * 9)
    assert [s[2] for s in runner.sizes] == widths[1:] + [64]


def _resize_bilinear_np(frame, scale):
    """The frame resized x``scale`` bilinearly (half-pixel centres)."""
    x = torch.from_numpy(frame)[None].permute(0, 3, 1, 2)
    return F.interpolate(x, scale_factor=scale, mode="bilinear",
                         align_corners=False)[0].permute(1, 2, 0).numpy()
