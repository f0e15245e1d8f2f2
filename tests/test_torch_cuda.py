"""The port on the card: its CUDA kernels against their plain versions,
their build, and its models, entries, tools and training paths against the
CPU (the port's correctness checks on the card; ``portbench/`` measures it).

Marked ``gpu``: each test but the ptxas reader's asks the ``cuda`` fixture,
which skips where there is no CUDA device (decided when the test runs,
never at import).  On a machine with an H100 and nvcc:

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


def _launches():
    """Every kernel wrapper's launch count so far, by name."""
    return {"dcn_fwd": dcn_fwd.launches, "dcn_bwd": dcn_bwd.launches,
            "conv3x3": conv3x3.launches,
            "conv3x3_fused": conv3x3_fused.launches,
            "conv3x3_narrow": conv3x3_narrow.launches,
            "dcn_block": modulated_deform_conv_block.launches}


def _since(before):
    """The launches since ``before`` (a :func:`_launches`), the card
    waited for."""
    torch.cuda.synchronize()
    return {k: v - before[k] for k, v in _launches().items()}


def _counts(dcn=0, conv=0, fused=0, narrow=0, bwd=0, block=0):
    return {"dcn_fwd": dcn, "dcn_bwd": bwd, "conv3x3": conv,
            "conv3x3_fused": fused, "conv3x3_narrow": narrow,
            "dcn_block": block}


def _step(forward):
    """A training step's launches: the forward's, and one DCN backward a
    DCN (the convs' gradients run cuDNN)."""
    return dict(forward, dcn_bwd=forward["dcn_fwd"])


def _randomise_offsets(model, seed, std=0.5):
    """The DCN offset/mask convs start at zero; random weights (from
    ``seed``, a seed or a generator) make the offsets reach a few
    pixels."""
    g = seed if isinstance(seed, torch.Generator) else _gen(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "conv_offset_mask" in name:
                p.copy_(torch.randn(p.shape, generator=g) * std)


# each model as its recipe gives it (full width), cut in depth: (recipe,
# network changes)
_MODELS = {
    "edvr_noup": ("train_EDVR_woTSA_RealVSR_YCbCr_Split.yml",
                  dict(front_RBs=1, back_RBs=1)),
    "tdan": ("train_TDAN_RealVSR_YCbCr_Split.yml", dict(nb_f=1, nb_b=1)),
    "edvr_x4": ("train_EDVRx4_TSA_Vimeo90K.yml",
                dict(front_RBs=1, back_RBs=1, nframes=5)),
    "edvr_l": ("train_EDVRx4_TSA_Vimeo90K.yml",
               dict(nf=128, front_RBs=1, back_RBs=1, nframes=5)),
    "tof": ("train_TOF_RealVSR_YCbCr_Split.yml", dict(nb=1)),
    "fstrn": ("train_FSTRN_RealVSR_YCbCr_Split.yml", {}),
    "rcan": ("train_RCAN_RealVSR_YCbCr_Split.yml",
             dict(num_group=1, num_block=1)),
}
# one forward's launches at _MODELS' depths, from the models' routing: on
# conv3x3 (64 outputs) the ResBlocks' convs, PCD's 10 offset convs, EDVR's
# fea_L2_conv2 / fea_L3_conv2 / L2_fea_conv / L1_fea_conv and HRconv, TSA's
# 6, TDAN's bottle_neck and 4 offset convs, TOF's trunk and HRconv, RCAN's
# RCABs, group conv and body conv; on conv3x3_fused (other widths) the 4
# conv_offset_mask (216), conv_last (3), TDAN's reconstruction, x4's
# upconv1 / upconv2; at nf 128 every conv but HRconv; FSTRN runs cuDNN alone
_FORWARD = {
    "edvr_noup": _counts(4, 19, 5),
    "tdan": _counts(4, 9, 6),
    "edvr_x4": _counts(4, 25, 7),
    "edvr_l": _counts(4, 1, 31),
    "tof": _counts(0, 3, 1),
    "fstrn": _counts(),
    "rcan": _counts(0, 4, 1),
}
# launches of one forward at the recipes' own depths, as _FORWARD counts
# them: EDVR_NoUp's 5 + 10 ResBlocks, TDAN's 5 + 10, EDVR x4's 5 + 10 (with
# TSA), EDVR-L's 5 + 40 at nf 128, TOF's 10 ResBlocks, RCAN's 5 groups of 2
_RECIPE_FORWARD = {
    "edvr_noup": _counts(4, 45, 5), "tdan": _counts(4, 35, 6),
    "edvr_x4": _counts(4, 51, 7), "edvr_l": _counts(4, 1, 117),
    "tof": _counts(0, 21, 1), "fstrn": _counts(), "rcan": _counts(0, 26, 1)}
# the nf 16 debug configs' step: the narrow DCN kernels, the conv on 32-byte
# chunks
_DEBUG_STEP = _step(_counts(4, 1, 23, 23))


def _recipe_opt(name, cuts=None):
    import os

    import yaml

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "train", name)) as f:
        opt = yaml.safe_load(f)
    opt["network_G"].update(cuts or {})
    return opt


def _sliced(plain, *args):
    """``plain(*args)``, on slices of the frames past 2^26 input elements
    (the plain DCN's autograd keeps some 80 f32 copies of its input): the
    outputs and the per-pixel gradients joined, the weight's gradient
    summed in f32 (the weight passed in f32: the same values) and rounded
    once."""
    b, h, w, c = args[0].shape
    n = max(1, 2 ** 26 // (h * w * c))
    if b <= n:
        return plain(*args)
    dt = [a.dtype for a in args if a.dim() == 4 and a.shape[:3] != (b, h, w)]
    parts = [plain(*[a[i:i + n] if a.shape[:3] == (b, h, w) else
                     a.float() if a.dim() == 4 else a for a in args])
             for i in range(0, b, n)]
    if torch.is_tensor(parts[0]):
        return torch.cat(parts)
    return tuple(torch.cat(p) if p[0].shape[:3] == (n, h, w)
                 else sum(p).to(dt[0]) for p in zip(*parts))


def _hold_fwd(x, off, mask, wgt, bias, dg, act, max_offset, om):
    """The DCN forward kernel in one form (``om``: DCNPack's offset/mask
    tensor read in place, the sigmoid in the kernel), one launch, against
    its plain version (check.py's tolerance); returns its output."""
    n = dcn_fwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_fwd_om(x, t, wgt, bias, dg, act=act, max_offset=max_offset)
        ref = _sliced(lambda *a: dcn_fwd_om_plain(*a, dg, act, max_offset),
                      x, t, wgt, bias)
    else:
        out = dcn_fwd(x, off, mask, wgt, bias, dg, act=act,
                      max_offset=max_offset)
        ref = _sliced(lambda *a: dcn_fwd_plain(*a, dg, act, max_offset), x,
                      off, mask, wgt, bias)
    torch.cuda.synchronize()
    assert dcn_fwd.launches == n + 1
    assert out.shape == ref.shape and out.dtype == x.dtype
    assert max_abs_err(out, ref) <= tolerance(ref)
    return out


def _hold_bwd(x, off, mask, wgt, g, dg, max_offset, om):
    """The DCN backward kernel in one form for the cotangent ``g``, one
    launch, each gradient finite and against its plain version
    (check.py's tolerance); no offset gradient past the clamp."""
    n = dcn_bwd.launches
    if om:
        t = _om(off, mask)
        out = dcn_bwd_om(x, t, wgt, g, dg, max_offset)
        ref = _sliced(lambda *a: dcn_bwd_om_plain(*a, dg, max_offset), x, t,
                      wgt, g)
        doff = out[1][..., :dg * 18]
    else:
        out = dcn_bwd(x, off, mask, wgt, g, dg, max_offset)
        ref = _sliced(lambda *a: dcn_bwd_plain(*a, dg, max_offset), x, off,
                      mask, wgt, g)
        doff = out[1]
    torch.cuda.synchronize()
    assert dcn_bwd.launches == n + 1
    for i, (o, r) in enumerate(zip(out, ref)):
        assert o.shape == r.shape and o.dtype == r.dtype, i
        assert torch.isfinite(o).all(), i
        assert max_abs_err(o, r) <= grad_tolerance(r), i
    if max_offset is not None:
        assert not doff[off.abs() > max_offset].any()


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
    _hold_fwd(*_dcn_inputs(shape, dtype, cuda), 8, act, max_offset, om)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,c2,act,residual", [
    ((3, 128, 256, 64), 0, "relu", False),
    ((3, 128, 256, 64), 0, None, True),
    ((3, 128, 256, 64), 64, "lrelu", False),
    ((3, 37, 45, 64), 0, "relu", True),    # tile walk across images
    ((3, 37, 45, 64), 64, "lrelu", False),  # ... with the concat input
    ((2, 96, 512, 64), 64, None, False),   # many tiles per block
    ((2, 37, 45, 16), 16, "relu", True),  # narrow inputs: 32-byte chunks
    ((2, 37, 45, 16), 0, "lrelu", False),  # one 32-byte chunk (HRconv, nf 16)
    ((1, 20, 24, 48), 0, None, True),     # 48 inputs: 32-byte chunks
    # the cells' own planes: the flagship's front ResBlocks and PCD L1
    # offset convs at 1024x512, a back ResBlock's conv2; the training
    # step's front convs (96 frames of 192x192); EDVR-L's HRconv at
    # 1792x1024; BasicVSR++'s reconstruction input conv (320 -> 64)
    ((3, 512, 1024, 64), 0, "relu", False),
    ((3, 512, 1024, 64), 64, "lrelu", False),
    ((1, 512, 1024, 64), 0, None, True),
    ((96, 192, 192, 64), 0, "relu", False),
    ((1, 1024, 1792, 64), 0, "lrelu", False),
    ((1, 180, 320, 320), 0, "lrelu", False),
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
    ((2, 37, 45, 16), 0, 108, "lrelu", True, False),  # 16 -> 108
    ((2, 37, 45, 16), 0, 16, "relu", True, False),    # nf 16 ResBlock
    ((2, 37, 45, 16), 16, 16, "lrelu", True, False),  # nf 16 PCD offsets
    ((2, 37, 45, 128), 0, 300, None, True, True),     # 2 chunks past 256
    # the cells' own planes: the flagship's conv_last with the centre frame
    # at 1024x512; EDVR-L's upconv1 at 448x256 and conv_last with its base
    # at 1792x1024; BasicVSR++'s last offset conv (27 x 16: 256 + 176
    # columns), its second pixel-shuffle conv and conv_last with its base
    # at 1280x720
    ((1, 512, 1024, 64), 0, 3, None, True, True),
    ((1, 256, 448, 128), 0, 512, "lrelu", True, False),
    ((1, 1024, 1792, 64), 0, 3, None, True, True),
    ((1, 180, 320, 64), 0, 432, None, True, False),
    ((1, 360, 640, 64), 0, 256, "lrelu", True, False),
    ((1, 720, 1280, 64), 0, 3, None, True, True),
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
    # the cells' own planes: the flagship's conv_offset_mask at 1024x512;
    # EDVR-L's front ResBlocks, PCD L1 offset convs and conv_offset_mask
    # (7 frames of 448x256) and upconv2 (at 896x512)
    (64, 0, 216, "lrelu", False, (3, 512, 1024)),
    (128, 0, 128, "relu", False, (7, 256, 448)),
    (128, 128, 128, "lrelu", False, (7, 256, 448)),
    (128, 0, 216, "lrelu", False, (7, 256, 448)),
    (128, 0, 256, "lrelu", False, (1, 512, 896)),
)] + [(_F32, 64, 64, 64, "lrelu", False, (2, 64, 96)),  # PCD L1 (64+64)
      (_F32, 128, 0, 64, None, True, (3, 24, 40)),
      # the training step's PCD L1 offset convs (96 frames of 192x192)
      (_F32, 64, 64, 64, "lrelu", False, (96, 192, 192))]


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
    _randomise_offsets(cpu, g, std=1.0)
    card = EDVRNoUp(**cfg, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, 3, 32, 64, 3, generator=g)
    before = _launches()
    with torch.inference_mode():
        ref = cpu(x)
        out = card(x.to(cuda)).cpu()
    assert _since(before) == _FORWARD["edvr_noup"]
    assert torch.isfinite(out).all()
    assert np.abs((out - ref).numpy()).max() <= 2e-2


@pytest.mark.parametrize("name", ["TDAN", "EDVR"])
def test_tdan_and_edvr_x4_on_card_match_cpu(cuda, name):
    """Full width (nf 64, 8 groups), cut depth and size, f32: the card
    (TF32 kernels) against the CPU; the forward's launches."""
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
    _randomise_offsets(cpu, g, std=0.3)
    card = cls(**cfg, device=cuda).eval()
    card.load_state_dict(cpu.state_dict())
    x = torch.rand(1, cfg["nframes"], 32, 64, 3, generator=g)
    before = _launches()
    with torch.inference_mode():
        ref = cpu(x)
        out = card(x.to(cuda)).cpu()
    assert _since(before) == _FORWARD["tdan" if name == "TDAN" else "edvr_x4"]
    assert out.shape == ref.shape and torch.isfinite(out).all()
    assert np.abs((out - ref).numpy()).max() <= 2e-2


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,max_offset,std", [
    ((1, 37, 45, 64), 8, 2.5),       # ragged tile edges, taps outside
    ((1, 37, 45, 64), 4, 2.5),       # the deployment clamp's footprint
    ((2, 48, 64, 64), None, 2.5),
    ((2, 48, 64, 64), 2, 2.5),       # many offsets beyond the clamp
    ((1, 32, 40, 64), None, 0.0),    # on the grid: one-sided differences
    ((1, 32, 40, 64), 8, 0.0),       # ... as a training step starts, ±8
    # corners outside the dx footprint: the global path (no clamp, and a
    # clamp wider than the footprint's radius of 8)
    ((1, 40, 72, 64), None, 12.0),
    ((1, 40, 72, 64), 12, 12.0),
])
def test_dcn_bwd_kernel_matches_plain(cuda, dtype, shape, max_offset, std,
                                      om):
    x, off, mask, wgt, _ = _dcn_inputs(shape, dtype, cuda, seed=4, std=std)
    g = torch.randn(*shape[:3], 64, generator=_gen(5)).to(cuda, dtype)
    _hold_bwd(x, off, mask, wgt, g, 8, max_offset, om)


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
    from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset
    from realvsr_tpu_torch.models.edvr import EDVRNoUp
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    opt = _recipe_opt("train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")
    opt.pop("augment")
    cfg = dict(nf=64, nframes=3, groups=8, front_RBs=1, back_RBs=1,
               dcn_max_offset=8)
    cpu = EDVRNoUp(**cfg, device="cpu", generator=_gen(7))
    _randomise_offsets(cpu, 8)
    ds = SyntheticVSRDataset(dict(N_frames=3, GT_size=64))
    items = [ds.get(i, np.random.default_rng(i)) for i in (1, 9)]
    batch = {k: torch.from_numpy(np.stack([it[k] for it in items]))
             for k in ("LQs", "GT")}
    grads, losses = {}, {}
    before = _launches()
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
    assert _since(before) == _step(_FORWARD["edvr_noup"])
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
    _hold_bwd(x, off, mask, wgt, g, 8, 8, om)


@pytest.mark.parametrize("name,side", [("tdan", 64), ("edvr_x4", 32),
                                       ("edvr_l", 32)],
                         ids=["TDAN", "EDVRx4_TSA", "EDVR_L"])
def test_tdan_and_edvr_x4_train_steps_on_card_match_cpu(cuda, name, side):
    """Card-vs-CPU steps of the two families: the recipe's network at
    full width and cut depth (TDAN nf 64, 1 + 1 ResBlocks, LQ 64x64; EDVR
    x4 + TSA nf 64, 8 groups, 1 + 1 ResBlocks, 5 frames, LQ 32x32; EDVR-L,
    the same at nf 128), batch 2 of motion-synthetic frames, f32, the card
    (TF32 kernels) against the CPU from the same weights (offset convs
    randomised); loss to 1e-3 relative, each gradient to 5e-2 of its
    largest magnitude plus the CPU's own change in it when the LQ input
    moves by TF32's rounding (2^-11 relative); the step's launches.  TSA's
    spatial attention (``sAtt_1``, ``sAtt_L1``: lrelu and 3x3 max pools
    after them) is the closest to that bound (PERF.md §7)."""
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    opt = _recipe_opt(*_MODELS[name])
    opt.pop("augment")
    cpu = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    _randomise_offsets(cpu, 13)
    batch = _batch(opt, side, "SyntheticMotion")
    grads, losses = {}, {}
    for dev in ("cpu", cuda):
        model = define_g(opt, device=dev, dcn_max_offset=8)
        model.load_state_dict(cpu.state_dict())
        state = create_train_state(model, opt)
        before = _launches()
        _, logs = make_split_train_step(model, opt)(
            state, {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[str(dev)] = logs["l_pix"].item()
        grads[str(dev)] = {k: p.grad.float().cpu()
                           for k, p in model.named_parameters()}
    assert _since(before) == _step(_FORWARD[name])
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
    _hold_fwd(x, off, mask, wgt, bias, 4, act, max_offset, om)
    _hold_bwd(x, off, mask, wgt, g, 4, max_offset, om)


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
    _hold_fwd(x, off, mask, wgt, bias, dg, "lrelu", max_offset, om)
    _hold_bwd(x, off, mask, wgt, g, dg, max_offset, om)


# the benchmark cells' own DCN planes (BENCHMARK.json): the flagship's L1
# restoring (3 frames of 1024x512, ±4) and in a batch-32 training step (96
# frames of 192x192, ±8); EDVR-L's L1 restoring (7 frames of 448x256, ±4)
# and in a training sample (7 frames of 64x64, ±8)
CELL_DCN = [((3, 512, 1024, 64), 4), ((96, 192, 192, 64), 8),
            ((7, 256, 448, 128), 4), ((7, 64, 64, 128), 8)]


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,max_offset", CELL_DCN, ids=[
    "edvr_noup_restore", "edvr_noup_train", "edvr_l_restore", "edvr_l_train"])
def test_dcn_at_the_cells_planes_matches_plain(cuda, shape, max_offset,
                                               dtype, om):
    """Both DCN kernels (64 or 128 channels in 8 groups) at each cell's
    planes, both forms, one launch each, against their plain versions."""
    x, off, mask, wgt, bias, g = _width_inputs(shape, 8, dtype, cuda,
                                               seed=31)
    _hold_fwd(x, off, mask, wgt, bias, 8, "lrelu", max_offset, om)
    _hold_bwd(x, off, mask, wgt, g, 8, max_offset, om)


@pytest.mark.parametrize("om", [False, True], ids=["separate", "om"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_dcn_fwd_128_many_tiles_per_block(cuda, dtype, om):
    """The 128-channel forward with ~3.5 tiles a block (456 tiles of 8 x 16
    over 132 SMs; ragged in H and W): its A-stage and weight rings wrap
    across tiles and the epilogue of one tile runs beside the next one's
    sampling."""
    x, off, mask, wgt, bias, _ = _width_inputs((3, 61, 300, 128), 8, dtype,
                                               cuda, seed=17)
    _hold_fwd(x, off, mask, wgt, bias, 8, "relu", 4, om)


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
    _hold_bwd(x, off, mask, wgt, g, 8, max_offset, False)


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


@pytest.mark.parametrize("name", ["tof", "fstrn", "rcan"],
                         ids=["TOF", "FSTRN", "RCAN"])
def test_tof_fstrn_rcan_train_steps_on_card_match_cpu(cuda, name):
    """Card-vs-CPU Split steps of the other generators: the recipe's
    network at full width and cut depth (TOF nf 64, 1 ResBlock;
    FSTRN as given; RCAN 1 group of 1 RCAB), LQ 64x64, batch 2 of
    motion-synthetic frames, f32; loss to 1e-3 relative, each gradient to
    5e-2 of its largest plus the CPU's own change under 2^-11 input noise;
    the step's launches (the backward runs cuDNN; FSTRN's 3-D convs are
    all cuDNN)."""
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_split_train_step

    opt = _recipe_opt(*_MODELS[name])
    opt.pop("augment")
    batch = _batch(opt, 64, "SyntheticMotion")
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
    before = _launches()
    card_loss, card = step(cuda, batch)
    assert _since(before) == _FORWARD[name]
    assert card_loss == pytest.approx(loss, rel=1e-3)
    lq = batch["LQs"]
    _, noisy = step("cpu", dict(batch, LQs=lq * (1 + 2.0 ** -11 * torch.randn(
        lq.shape, generator=_gen(16)))))
    _within_spread(grads, card, noisy)


def test_gan_step_on_card_matches_cpu(cuda):
    """The card-vs-CPU GAN-Split step: the GAN recipe's G
    (EDVR_NoUp, nf 64, 8 groups, 5 + 10 ResBlocks, offset convs randomised)
    and D (MultiscaleDiscriminator_v4, nf 64) on a Synthetic batch of 2 at
    64x64, f32, augmentation off: losses to 1e-3 relative; each gradient of
    G and D and each of D's running statistics after the step to 5e-2 of
    its largest plus the CPU's own change under 2^-11 input noise; the
    Split step's kernel launches (D runs none)."""
    from realvsr_tpu_torch.models import define_d, define_g
    from realvsr_tpu_torch.train.gan import (create_gan_train_state,
                                             make_gan_split_train_step)

    opt = _recipe_opt("train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml")
    opt["augment"] = None
    ref_g = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    _randomise_offsets(ref_g, 13)
    ref_d = define_d(opt, device="cpu", generator=_gen(14))
    batch = _batch(opt, 64, "Synthetic")

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
    before = _launches()
    card_losses, card = step(cuda, batch)
    assert _since(before) == _step(_RECIPE_FORWARD["edvr_noup"])
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
    _randomise_offsets(ref, 1)
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
    _randomise_offsets(model, 1)
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
      GAN step's card-vs-CPU bound, 5e-2 of the largest
      (``test_gan_step_on_card_matches_cpu``)."""
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
    out = _hold_fwd(x, off, mask, wgt, bias, 16, None, None, om)
    assert out.shape == (1, 180, 320, 64)


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


# ---- The build, the models through the port's entries and tools ----------

def _ptxas_rows(log):
    """(function, spill store bytes, spill load bytes) of every function in
    an ``nvcc -Xptxas -v`` log."""
    rows, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[1].strip()
        elif "spill stores" in line:
            parts = line.replace(",", "").split()
            rows.append((name, int(parts[parts.index("stores") - 3]),
                         int(parts[parts.index("loads") - 3])))
    return rows


def test_ptxas_rows_read_every_function():
    """The spill test's reading of ptxas's lines (no card needed)."""
    log = ("ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'\n"
           "ptxas info    : Function properties for _Z1kv\n"
           "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas info    : Function properties for _Z3devv\n"
           "    16 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n")
    assert _ptxas_rows(log) == [("_Z1kv", 8, 4), ("_Z3devv", 0, 0)]


def test_kernel_sources_build_without_spills(cuda, tmp_path):
    """Every ``csrc/*.cu`` built once, in parallel, with the port's nvcc
    flags (``-Xptxas -v`` among them) into a temporary directory: ptxas
    reports its functions, and no spill store or load in any of them."""
    import subprocess

    from realvsr_tpu_torch.ops.kernels import _build

    procs = {src.stem: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
         str(tmp_path / f"{src.stem}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in sorted(_build.CSRC.glob("*.cu"))}
    assert {"conv3x3", "dcn_fwd", "dcn_bwd", "dcn_narrow"} <= procs.keys()
    for name, proc in procs.items():
        log = proc.communicate(timeout=1200)[0]
        assert proc.returncode == 0, log[-4000:]
        rows = _ptxas_rows(log)
        print(f"{name}.cu: {len(rows)} functions")
        assert rows, name
        assert not [r for r in rows if r[1] or r[2]], (name, rows)


def _model(name, dev, dtype=torch.float32, seed=0, max_offset=4):
    """(options, model) of ``_MODELS[name]``: seeded weights, DCN offsets
    clamped to ±``max_offset`` (the deployment's ±4 by default)."""
    from realvsr_tpu_torch.models import define_g

    recipe, cuts = _MODELS[name]
    opt = _recipe_opt(recipe, cuts)
    return opt, define_g(opt, device=dev, dtype=dtype, generator=_gen(seed),
                         dcn_max_offset=max_offset)


def _write_clip(root, frames, h, w, seed):
    """A seeded clip of smooth texture moving 3 px a frame as PNGs under
    ``root/000``."""
    import os

    import cv2

    rng = np.random.default_rng(seed)
    base = cv2.resize(rng.random((h // 8, w // 8 + 8, 3)).astype(np.float32),
                      (w + 3 * frames + 8, h),
                      interpolation=cv2.INTER_CUBIC)
    os.makedirs(os.path.join(root, "000"))
    for t in range(frames):
        img = np.clip(base[:, 3 * t:3 * t + w] * 255, 0, 255).round()
        cv2.imwrite(os.path.join(root, "000", f"{t:05d}.png"),
                    img.astype(np.uint8))
    return root


@pytest.mark.parametrize("name", list(_MODELS))
def test_models_restore_on_card_as_on_cpu(cuda, tmp_path, name):
    """Each model at its recipe's widths (cut depth; seeded weights, DCN
    offsets of a few pixels, ±4): a 5-frame 64x64 PNG clip through
    ``evaluate_wo_gt`` in bf16 on the card, each window's launches held to
    the model's routing and every frame written at the output's size; then
    one window's forward on the card in f32 (TF32 kernels) and in bf16
    against the CPU in f32, within 2e-2 and 5e-2 of the output's largest
    magnitude (8-bit mantissas through the same depth)."""
    import cv2

    from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt

    opt, cpu = _model(name, "cpu", seed=40)
    _randomise_offsets(cpu, 41)
    net = opt["network_G"]
    n, scale = net.get("nframes") or net["num_frames"], opt["scale"] or 1
    cards = {}
    for dtype in (torch.float32, torch.bfloat16):
        cards[dtype] = _model(name, cuda, dtype)[1].eval()
        cards[dtype].load_state_dict(cpu.state_dict())
    clip = _write_clip(str(tmp_path / "lq"), 5, 64, 64, seed=42)
    before = _launches()
    evaluate_wo_gt(cards[torch.bfloat16], None, clip, n_frames=n,
                   save_folder=str(tmp_path / "out"))
    assert _since(before) == {k: 5 * v for k, v in _FORWARD[name].items()}
    saved = sorted((tmp_path / "out" / "000").iterdir())
    assert len(saved) == 5
    for f in saved:
        assert cv2.imread(str(f)).shape == (64 * scale, 64 * scale, 3)
    x = torch.rand(1, n, 64, 64, 3, generator=_gen(43))
    with torch.inference_mode():
        ref = cpu.eval()(x)
        top = ref.abs().max().item()
        for dtype, rel in ((torch.float32, 2e-2), (torch.bfloat16, 5e-2)):
            out = cards[dtype](x.to(cuda, dtype)).float().cpu()
            err = (out - ref).abs().max().item()
            print(f"{name} {dtype}: {err} of {top}")
            assert out.shape == ref.shape and torch.isfinite(out).all()
            assert err <= rel * top, dtype


def _hold_close(out, ref, rel=1e-2):
    """``out`` within ``rel`` of ``ref``'s largest magnitude (both f32 on
    the host)."""
    assert out.shape == ref.shape and torch.isfinite(out).all()
    err, top = (out - ref).abs().max().item(), ref.abs().max().item()
    assert err <= rel * top, (err, top)


@pytest.mark.parametrize("name", ["edvr_noup", "edvr_x4"])
def test_streaming_entries_on_card(cuda, name):
    """``StreamingRunner`` on the card (bf16, full width, cut depth,
    offsets of a few pixels): a frame's pyramid launches the front
    ResBlocks' and fea_L2_conv2 / fea_L3_conv2's convs, and with one fuse
    a window's kernels; ``run`` launches one pyramid a frame and one fuse
    a window and equals the sliding window of ``make_forward``;
    ``run_lazy`` equals ``run``; at 3 frames ``run_scan`` launches as
    ``run`` and equals it, and ``run_scan_clips`` equals ``run_scan`` of
    each clip; each within 1e-2 of the output's largest magnitude."""
    from realvsr_tpu_torch.eval.sliding_window import (make_forward,
                                                       sliding_window_infer)
    from realvsr_tpu_torch.eval.streaming import StreamingRunner

    _, model = _model(name, "cpu", seed=44)
    _randomise_offsets(model, 45)
    model = model.to(cuda, torch.bfloat16)
    model.dtype = torch.bfloat16
    n = model.nframes
    frames = np.random.default_rng(46).random((6, 32, 64, 3)).astype(
        np.float32)
    t = frames.shape[0]
    ref = torch.stack([torch.from_numpy(o) for _, o in sliding_window_infer(
        make_forward(model), frames, n, device=cuda)])
    runner = StreamingRunner(model, device=cuda)
    one = runner._frames(frames[:1])
    with torch.inference_mode():
        before = _launches()
        pyr = runner._pyramid(one)
        pyramid = _since(before)
        before = _launches()
        runner._fuse((pyr,) * n, one)
        fuse = _since(before)
    assert pyramid == _counts(conv=4)
    assert {k: v + pyramid[k] for k, v in fuse.items()} == _FORWARD[name]
    window = {k: t * (v + pyramid[k]) for k, v in fuse.items()}
    before = _launches()
    out = runner.run(frames)
    assert _since(before) == window
    out = out.float().cpu()
    _hold_close(out, ref)
    _hold_close(torch.stack(list(runner.run_lazy(frames))).float().cpu(),
                out)
    if n != 3:
        return
    before = _launches()
    scan = runner.run_scan(frames)
    assert _since(before) == window
    _hold_close(scan.float().cpu(), out)
    clips = np.stack([frames, frames[::-1]])
    both = runner.run_scan_clips(clips).float().cpu()
    for b in range(2):
        _hold_close(both[b], runner.run_scan(clips[b]).float().cpu())


def _flagship(cuda, dtype=torch.bfloat16, max_offset=4, seed=47, std=0.5):
    """EDVR_NoUp at its widths, 1 + 1 ResBlocks, offsets randomised."""
    _, model = _model("edvr_noup", "cpu", seed=seed, max_offset=max_offset)
    _randomise_offsets(model, seed + 1, std)
    model = model.to(cuda, dtype).eval()
    model.dtype = dtype
    return model


def test_tiled_forward_matches_full_frame_beyond_receptive_field_on_card(
        cuda):
    """The flagship (bf16, cut depth) on a 448x640 window in 288x384 tiles,
    overlap 32: ``make_batched_tiled_forward`` launches one window's
    kernels for all four tiles and equals ``make_tiled_forward``'s loop;
    both equal the full frame's forward on the pixels farther than
    ``receptive_field_rows`` from every inner tile edge, within 1e-2 of the
    largest magnitude."""
    from realvsr_tpu_torch.eval.sliding_window import make_forward
    from realvsr_tpu_torch.eval.tiled import (make_batched_tiled_forward,
                                              make_tiled_forward,
                                              receptive_field_rows,
                                              tile_grid)

    model = _flagship(cuda)
    hd, tile, overlap = (448, 640), (288, 384), 32
    window = torch.rand(3, *hd, 3, generator=_gen(49)).to(cuda)
    batched = make_batched_tiled_forward(model, tile_hw=tile,
                                         overlap=overlap, device=cuda)
    before = _launches()
    out = batched(window)
    assert _since(before) == _FORWARD["edvr_noup"]
    out = out.float().cpu()
    loop = make_tiled_forward(model, tile_hw=tile, overlap=overlap,
                              device=cuda)
    _hold_close(out, loop(window).float().cpu())
    full = make_forward(model)(window).float().cpu()
    rf = receptive_field_rows(1, 1, 4)
    (th, tw), tiles = tile_grid(*hd, tile, overlap)
    assert len(tiles) == 4
    keep = torch.zeros(hd, dtype=torch.bool)
    for ty, tx, (vy0, vy1, vx0, vx1) in tiles:
        ys = torch.arange(vy0, vy1)[:, None]
        xs = torch.arange(vx0, vx1)[None, :]
        far = torch.ones(vy1 - vy0, vx1 - vx0, dtype=torch.bool)
        if ty > 0:
            far &= ys - ty >= rf
        if ty + th < hd[0]:
            far &= ty + th - 1 - ys >= rf
        if tx > 0:
            far &= xs - tx >= rf
        if tx + tw < hd[1]:
            far &= tx + tw - 1 - xs >= rf
        keep[vy0:vy1, vx0:vx1] = far
    print(f"receptive field {rf} rows: {int(keep.sum())} of {keep.numel()}")
    assert keep.sum() >= keep.numel() // 4
    _hold_close(out[keep], full[keep])


def test_flip_test_on_card_averages_the_four_flipped_forwards(cuda):
    """The test CLIs' restorer with ``--flip_test`` on the card (the
    flagship, bf16, cut depth): frame 1 equals the mean of the four flipped
    forwards of its window, within 1e-2 of the largest magnitude."""
    from realvsr_tpu_torch.eval.sliding_window import make_forward
    from realvsr_tpu_torch.tools._cli import parse_args, restorer

    model = _flagship(cuda)
    frames = np.random.default_rng(50).random((4, 32, 64, 3)).astype(
        np.float32)
    restore = restorer(parse_args(["-opt", "test.yml", "--flip_test"], ""),
                       {"datasets": {"test": {}}, "network_G": {"nframes": 3}},
                       model)
    flipped = dict(restore(frames))[1]
    forward = make_forward(model)
    w3 = torch.from_numpy(frames[:3]).to(cuda)
    with torch.inference_mode():
        mean = sum(forward(w3.flip(d)).float().flip(d) if d else
                   forward(w3).float() for d in ((), (-2,), (-3,), (-3, -2)))
    _hold_close(torch.from_numpy(flipped), mean.cpu() / 4)


def _write_libsvm(tmp_path):
    """A libsvm model (3 seeded support vectors) and range file in the
    BRISQUE release's format (the card's machine has no scikit-learn to
    fit one)."""
    rng = np.random.default_rng(42)
    sv, coef = rng.random((3, 36)), rng.normal(0, 1, 3)
    lines = ["svm_type epsilon_svr", "kernel_type rbf", "gamma 0.05",
             "nr_class 2", "total_sv 3", "rho -0.3", "SV"]
    lines += [" ".join([f"{c:.8f}"] + [f"{j + 1}:{v[j]:.8f}"
                                        for j in range(36)])
              for c, v in zip(coef, sv)]
    model, ranges = tmp_path / "allmodel", tmp_path / "allrange"
    model.write_text("\n".join(lines) + "\n")
    ranges.write_text("\n".join(["-1 1"] + [f"{j + 1} {-1.0 - j / 36} "
                                            f"{3.0 + j}" for j in range(36)])
                      + "\n")
    return str(model), str(ranges)


def test_dists_niqe_model_and_brisque_on_card_match_cpu(cuda, tmp_path):
    """DISTS (seeded random VGG16) of two 64x96 frames against noisy copies,
    card vs CPU in f32 within 1e-3 relative; on 4 PNG frames of 192x288, a
    NIQE model fitted on the card (``fit_niqe_model``, 48-pixel blocks)
    against the CPU's, its mean within 1e-6 of its largest; BRISQUE's
    features within 1e-6 of their largest; the NIQE and BRISQUE (a libsvm
    file written here) scores within 1e-4 relative."""
    import os

    from realvsr_tpu_torch.data.imageio import read_gray
    from realvsr_tpu_torch.eval import brisque, niqe, perceptual

    rng = np.random.default_rng(51)
    x = rng.random((2, 64, 96, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.05, x.shape), 0, 1).astype(np.float32)
    card = perceptual.dists(perceptual.init_lpips_params(
        with_dists=True, device=cuda), x, y).cpu()
    cpu = perceptual.dists(perceptual.init_lpips_params(
        with_dists=True, device="cpu"), x, y)
    assert ((card - cpu).abs() / cpu.abs()).max().item() <= 1e-3
    root = _write_clip(str(tmp_path / "frames"), 4, 192, 288, seed=52)
    fitted = {dev: niqe.fit_niqe_model(root, block_size=48, device=dev)
              for dev in (cuda, "cpu")}
    mu = fitted["cpu"]["mu"]
    assert np.abs(fitted[cuda]["mu"] - mu).max() <= 1e-6 * np.abs(mu).max()
    img = read_gray(os.path.join(root, "000", "00002.png"))
    feats = (brisque.brisque_features(img, cuda).cpu(),
             brisque.brisque_features(img, "cpu"))
    assert ((feats[0] - feats[1]).abs().max()
            <= 1e-6 * feats[1].abs().max())
    svm = brisque.load_libsvm_model(*_write_libsvm(tmp_path))
    for score in (lambda dev: niqe.niqe_score(img, fitted["cpu"], device=dev),
                  lambda dev: brisque.brisque_score(img, svm, device=dev)):
        on_card, on_cpu = score(cuda), score("cpu")
        assert abs(on_card / on_cpu - 1) <= 1e-4, (on_card, on_cpu)


def test_flow_warp_and_trilinear_on_card_match_cpu(cuda):
    """``ops/warp.flow_warp`` (both paddings, flows of std 3 px, many past
    the edges) and FSTRN's trilinear cross-space residual (x4, half-pixel
    centres) in f32, card against CPU within 1e-5 of the output's largest
    magnitude."""
    from realvsr_tpu_torch.ops.warp import flow_warp

    g = _gen(53)
    x = torch.randn(4, 96, 128, 3, generator=g)
    flow = torch.randn(4, 96, 128, 2, generator=g) * 3
    vol = torch.rand(2, 3, 3, 48, 64, generator=g)
    cases = [(lambda a, b, p=p: flow_warp(a, b, p), (x, flow))
             for p in ("zeros", "border")]
    cases.append((lambda v: F.interpolate(v, size=(3, 192, 256),
                                          mode="trilinear",
                                          align_corners=False), (vol,)))
    for fn, args in cases:
        ref = fn(*args)
        out = fn(*[a.to(cuda) for a in args]).cpu()
        assert out.shape == ref.shape
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_general_dcn_surface_on_card_matches_plain(cuda):
    """The general DCN surface as a user calls it, bf16 on 2 frames of
    21x37: DCNPacks at 64 -> 32 (PCD's mode) and 256 -> 256 (offsets from
    x itself) and ``DeformConvModule`` (DCNv1, 64 -> 64 in 8 groups) at p1
    launch ``dcn_narrow.cu`` each way, a DCNPack at kernel size 5 and
    ``DeformConvModule`` at p0 run the plain op: 3 forward and 3 backward
    launches, the two 3x3 offset convs on conv3x3_fused.  Each kernel
    module's output and gradients (inputs, parameters) against the plain
    op on the same card inputs and cotangents, check.py's tolerances."""
    from realvsr_tpu_torch.models.common import (DCNPack, DeformConvModule,
                                                 reset_parameters)
    from realvsr_tpu_torch.ops.deform_conv import split_om

    g, bf = _gen(54), torch.bfloat16
    mods = [DCNPack(64, 32, 8), DCNPack(256, 256, 8, extra_offset_mask=False),
            DeformConvModule(64, 64, 3, padding=1, deformable_groups=8),
            DCNPack(64, 64, 8, kernel_size=5, padding=2,
                    extra_offset_mask=False),
            DeformConvModule(64, 64, 3, padding=0, deformable_groups=8)]
    for m in mods:
        reset_parameters(torch.nn.Sequential(m), g)
        if isinstance(m, DCNPack):
            _randomise_offsets(m, 55, std=0.1)
        m.to(cuda, bf)
    b, h, w = 2, 21, 37

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(cuda, bf)

    x64, x256 = rand(b, h, w, 64), rand(b, h, w, 256)
    calls = [(mods[0], (x64, x64), "lrelu"), (mods[1], (x256,), None),
             (mods[2], (x64, rand(b, h, w, 8 * 18, scale=2.0)), None),
             (mods[3], (x64,), None),
             (mods[4], (x64, rand(b, h - 2, w - 2, 8 * 18, scale=2.0)), None)]
    cots = [torch.randn(b, h - 2 * (i == 4), w - 2 * (i == 4),
                        m.weight.shape[0], generator=g).to(cuda)
            for i, (m, _, _) in enumerate(calls)]

    def run(forward):
        res = []
        for (m, ins, act), cot in zip(calls, cots):
            m.zero_grad(set_to_none=True)
            leaves = [t.detach().clone().requires_grad_() for t in ins]
            y = forward(m, leaves, act)
            (y.float() * cot).sum().backward()
            res.append([y.detach()] + [t.grad for t in leaves]
                       + [p.grad for p in m.parameters()])
        return res

    def modules(m, leaves, act):
        return m(*leaves, act=act) if isinstance(m, DCNPack) else m(*leaves)

    def plain(m, leaves, act):
        if isinstance(m, DeformConvModule):
            return modulated_deform_conv_plain(
                leaves[0], leaves[1], None, m.weight, None, m.stride,
                m.padding, m.dilation, m.deformable_groups, groups=m.groups)
        return modulated_deform_conv_plain(
            leaves[0], *split_om(m.conv_offset_mask(leaves[-1]),
                                 m.deformable_groups),
            m.weight, m.bias, m.stride, m.padding, m.dilation,
            m.deformable_groups, m.max_offset, act, m.groups)

    before = _launches()
    got = run(modules)
    assert _since(before) == _counts(dcn=3, fused=2, bwd=3)
    assert all(torch.isfinite(t).all() for r in got for t in r)
    for o, r in zip(got[:3], run(plain)[:3]):
        assert max_abs_err(o[0], r[0]) <= tolerance(r[0])
        for a, e in zip(o[1:], r[1:]):
            assert max_abs_err(a, e) <= grad_tolerance(e)


def _batch(opt, side, mode, n_items=2, seed=3):
    """``n_items`` clips of the ``mode`` train set at LQ ``side`` x
    ``side`` for ``opt``'s network: {"LQs", "GT"} on the host."""
    from realvsr_tpu_torch.data.synthetic import (SyntheticMotionVSRDataset,
                                                  SyntheticVSRDataset)

    net, scale = opt["network_G"], opt["scale"] or 1
    n = net.get("nframes") or net["num_frames"]
    if mode == "SyntheticMotion":
        gt = side * scale
        ds = SyntheticMotionVSRDataset(dict(N_frames=n, GT_size=gt,
                                            scale=scale, frame_h=gt + 32,
                                            frame_w=gt + 32))
    else:
        ds = SyntheticVSRDataset(dict(N_frames=n, GT_size=side))
    items = [ds.get(i, np.random.default_rng(i))
             for i in range(seed, seed + 14 * n_items, 14)]
    return {k: torch.from_numpy(np.stack([it[k] for it in items]))
            for k in ("LQs", "GT")}


@pytest.mark.parametrize("recipe,cuts,mode,counts", [
    ("debug_EDVR_woTSA_Split_synthetic.yml", {}, "Synthetic",
     _DEBUG_STEP),
    ("train_EDVR_woTSA_RealVSR_YCbCr_Combine.yml",
     dict(front_RBs=1, back_RBs=1), "Synthetic", _step(_FORWARD["edvr_noup"])),
    ("train_EDVR_woTSA_Vimeo90K.yml", dict(front_RBs=1, back_RBs=1),
     "SyntheticMotion", _step(_FORWARD["edvr_noup"])),
], ids=["debug_nf16_Split", "Combine", "AllPair"])
def test_wrapper_train_steps_on_card_match_cpu(cuda, recipe, cuts, mode,
                                               counts):
    """One step through ``make_train_step``'s dispatch on the recipe's
    ``model`` (Split at the nf 16 debug width: the narrow DCN and the conv
    on 32-byte chunks; Combine; the bare AllPair) at its network's widths
    (EDVR_NoUp cut to 1 + 1 ResBlocks), batch 2 at 64x64, f32, ±8, offsets
    randomised: the card (TF32 kernels) against the CPU from the same
    weights and batch, loss to 1e-3 relative, each gradient to 5e-2 of its
    largest magnitude; the card step's launches."""
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_train_step

    opt = _recipe_opt(recipe, cuts)
    opt["augment"] = None
    ref = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    _randomise_offsets(ref, 13)
    batch = _batch(opt, 64, mode)
    grads, losses = {}, {}
    for dev in ("cpu", cuda):
        model = define_g(opt, device=dev, dcn_max_offset=8)
        model.load_state_dict(ref.state_dict())
        before = _launches()
        _, logs = make_train_step(model, opt)(
            create_train_state(model, opt),
            {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        losses[str(dev)] = logs.get("l_tot", logs["l_pix"]).item()
        grads[str(dev)] = {k: p.grad.float().cpu()
                           for k, p in model.named_parameters()}
    assert _since(before) == counts
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-3)
    for k, r in grads["cpu"].items():
        err = (grads["cuda"][k] - r).abs().max().item()
        assert err <= 5e-2 * r.abs().max().item(), k


def test_ft_tsa_only_step_on_card_updates_tsa_alone(cuda):
    """EDVR x4 + TSA's Split step (nf 64, 8 groups, 1 + 1 ResBlocks, 5
    frames, LQ 32x32, batch 2 of motion-synthetic frames, f32, ±8) with
    ``ft_tsa_only`` (2: the first update trains ``tsa_fusion`` alone): on
    the card every other parameter stays bit-unchanged and every
    ``tsa_fusion`` one moves, to the CPU's update within 2 LR (Adam's first
    update is LR * g / (|g| + eps): a small gradient's sign may differ)
    plus 1e-6 of their largest."""
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_train_step

    opt = _recipe_opt(*_MODELS["edvr_x4"])
    opt["augment"] = None
    opt["train"]["ft_tsa_only"] = 2
    init = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    _randomise_offsets(init, 13)
    batch = _batch(opt, 32, "SyntheticMotion")
    after = {}
    for dev in ("cpu", cuda):
        model = define_g(opt, device=dev, dcn_max_offset=8)
        model.load_state_dict(init.state_dict())
        make_train_step(model, opt)(
            create_train_state(model, opt),
            {k: v.to(dev) for k, v in batch.items()},
            torch.Generator(device=dev))
        after[str(dev)] = {k: p.detach().float().cpu()
                           for k, p in model.named_parameters()}
    start = init.state_dict()
    tsa = [k for k in after["cuda"] if "tsa_fusion" in k]
    assert tsa
    for k, v in after["cuda"].items():
        assert torch.equal(v, start[k]) != (k in tsa), k
    lr = float(opt["train"]["lr_G"])
    tol = 2.0001 * lr + 1e-6 * max(after["cpu"][k].abs().max().item()
                                   for k in tsa)
    for k in tsa:
        assert (after["cuda"][k] - after["cpu"][k]).abs().max() <= tol, k


def test_tof_gan_step_on_card_matches_cpu(cuda):
    """A GAN-Split step of ``train_TOF-GAN_RealVSR_YCbCr_Split.yml``: G
    (TOF, nf 64, 1 ResBlock; SpyNet's BatchNorms) and D
    (MultiscaleDiscriminator_v4, nf 64) on a motion-synthetic batch of 2
    at 64x64, f32, augmentation off: losses to 1e-3 relative; each
    gradient of G and D and each running statistic of either after the
    step to 5e-2 of its largest plus the CPU's own change under 2^-11
    input noise; the step's conv3x3 launches (D runs none)."""
    from realvsr_tpu_torch.models import define_d, define_g
    from realvsr_tpu_torch.train.gan import (create_gan_train_state,
                                             make_gan_split_train_step)

    opt = _recipe_opt("train_TOF-GAN_RealVSR_YCbCr_Split.yml", dict(nb=1))
    opt["augment"] = None
    ref_g = define_g(opt, device="cpu", generator=_gen(12))
    ref_d = define_d(opt, device="cpu", generator=_gen(14))
    batch = _batch(opt, 64, "SyntheticMotion")

    def step(dev, b):
        gm = define_g(opt, device=dev)
        gm.load_state_dict(ref_g.state_dict())
        dm = define_d(opt, device=dev)
        dm.load_state_dict(ref_d.state_dict())
        _, logs = make_gan_split_train_step(gm, opt)(
            create_gan_train_state(gm, dm, opt),
            {k: v.to(dev) for k, v in b.items()},
            torch.Generator(device=dev))
        vals = {}
        for n, m in (("G", gm), ("D", dm)):
            vals.update({f"{n}.{k}": p.grad for k, p in m.named_parameters()})
            vals.update({f"{n}.{k}": t for k, t in m.named_buffers()
                         if "running" in k})
        return ({k: logs[k].item() for k in ("l_g_total", "l_d_real",
                                             "l_d_fake")},
                {k: v.float().cpu() for k, v in vals.items()})

    losses, ref = step("cpu", batch)
    before = _launches()
    card_losses, card = step(cuda, batch)
    assert _since(before) == _FORWARD["tof"]
    for k, v in losses.items():
        assert card_losses[k] == pytest.approx(v, rel=1e-3), k
    lq = batch["LQs"]
    _, noisy = step("cpu", dict(batch, LQs=lq * (1 + 2.0 ** -11 * torch.randn(
        lq.shape, generator=_gen(16)))))
    _within_spread(ref, card, noisy)


_EDVR_L = dict(nf=128, back_RBs=40)
# (config, train set in place of the config's (None: its own), mixed
# precision (None: the config's), network changes, launches a step): the
# debug configs (nf 16: the narrow kernels) and the motion smoke configs as
# the training command line runs them, with validation and checkpoints;
# the published recipes' networks in f32 and bf16 on synthetic data
_TRAINER_RUNS = [
    ("debug_EDVR_woTSA_Split_synthetic.yml", None, None, {},
     _DEBUG_STEP),
    ("debug_EDVR-GAN_Split_synthetic.yml", None, None, {},
     _DEBUG_STEP),
    ("smoke_TDAN_motion.yml", None, None, {}, _step(_RECIPE_FORWARD["tdan"])),
    ("smoke_EDVRx4_motion.yml", None, None, {},
     _step(_RECIPE_FORWARD["edvr_x4"])),
    ("smoke_TOF_motion.yml", None, None, {}, _RECIPE_FORWARD["tof"]),
    ("smoke_FSTRN_motion.yml", None, None, {}, _RECIPE_FORWARD["fstrn"]),
    ("smoke_RCAN_motion.yml", None, None, {}, _RECIPE_FORWARD["rcan"]),
] + [(cfg, mode, bf16, net, counts) for bf16 in (False, True)
     for cfg, mode, net, counts in (
    ("train_EDVR_woTSA_RealVSR_YCbCr_Split.yml", "Synthetic", {},
     _step(_RECIPE_FORWARD["edvr_noup"])),
    ("train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml", "Synthetic", {},
     _step(_RECIPE_FORWARD["edvr_noup"])),
    ("train_EDVR_woTSA_RealVSR_YCbCr_Combine.yml", "Synthetic", {},
     _step(_RECIPE_FORWARD["edvr_noup"])),
    ("train_EDVR_woTSA_Vimeo90K.yml", "SyntheticMotion", {},
     _step(_RECIPE_FORWARD["edvr_noup"])),
    ("train_TDAN_RealVSR_YCbCr_Split.yml", "SyntheticMotion", {},
     _step(_RECIPE_FORWARD["tdan"])),
    ("train_EDVRx4_TSA_Vimeo90K.yml", "SyntheticMotion", {},
     _step(_RECIPE_FORWARD["edvr_x4"])),
    ("train_EDVRx4_TSA_Vimeo90K.yml", "SyntheticMotion", _EDVR_L,
     _step(_RECIPE_FORWARD["edvr_l"])),
    ("train_TOF_RealVSR_YCbCr_Split.yml", "SyntheticMotion", {},
     _RECIPE_FORWARD["tof"]),
    ("train_TOF-GAN_RealVSR_YCbCr_Split.yml", "SyntheticMotion", {},
     _RECIPE_FORWARD["tof"]),
    ("train_FSTRN_RealVSR_YCbCr_Split.yml", "SyntheticMotion", {},
     _RECIPE_FORWARD["fstrn"]),
    ("train_RCAN_RealVSR_YCbCr_Split.yml", "SyntheticMotion", {},
     _RECIPE_FORWARD["rcan"]))]


def _trainer_opt(path, root, mode, bf16, net, niter):
    """``configs/train/<path>`` parsed as the training command line parses
    it, then cut: ``niter`` iterations at batch 2 of a small train set;
    with ``mode`` that train set at the recipe's frames and a 64-pixel LQ
    crop, no validation and the recipe's augmentation unless it swaps
    patches of GT and LQ at x4 (cutblur raises there); else the config's
    own data, validated and checkpointed every 2 iterations."""
    import os

    from realvsr_tpu_torch.core.config import parse

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    opt = parse(os.path.join(repo, "configs", "train", path), is_train=True,
                root=root)
    opt["network_G"].update(net)
    train = opt["datasets"]["train"]
    n, scale = train["N_frames"], opt["scale"] or 1
    if mode:
        train = opt["datasets"]["train"] = dict(
            name=f"{mode}_Train", mode=mode, phase="train", scale=scale,
            N_frames=n, GT_size=64 * scale, n_workers=2, dataset_ratio=2)
        if mode == "SyntheticMotion":
            train.update(frame_h=64 * scale + 32, frame_w=64 * scale + 32)
        opt["train"].update(val_freq=None, mixed_precision=bf16)
        opt["logger"]["save_checkpoint_freq"] = 10 ** 9
        opt["path"]["pretrain_model_G"] = None
        if scale > 1:
            opt["augment"] = None
    else:
        opt["train"]["val_freq"] = 2
        opt["logger"]["save_checkpoint_freq"] = 2
        if train["mode"] == "SyntheticMotion":
            train.update(frame_h=train["GT_size"] + 32,
                         frame_w=train["GT_size"] + 32)
    train.update(batch_size=2, num_seqs=2, frames_per_seq=n + 1)
    opt["train"]["niter"] = niter
    opt["logger"]["print_freq"] = 2
    return opt


def _run_trainer(opt):
    """``opt`` through the port's Trainer on the card at the training
    command line's DCN clamp, offsets randomised; returns (the Trainer,
    each step's (launches, logs), the validations' (step, PSNR), every
    parameter of G and D before the run)."""
    from realvsr_tpu_torch.tools.train import DCN_MAX_OFFSET
    from realvsr_tpu_torch.train.trainer import Trainer

    trainer = Trainer(opt, device="cuda", dcn_max_offset=DCN_MAX_OFFSET)
    _randomise_offsets(trainer.model, 11)
    named = {f"{n}.{k}": p for n, net in (("G", trainer.model),
                                          ("D", trainer.model_d))
             if net is not None for k, p in net.named_parameters()}
    before = {k: p.detach().clone() for k, p in named.items()}
    steps, vals = [], []
    inner_step, inner_val = trainer.train_step, trainer.validate

    def step(state, batch, gen):
        n0 = _launches()
        state, logs = inner_step(state, batch, gen)
        steps.append((_since(n0), logs))
        return state, logs

    def validate(at):
        vals.append((at, inner_val(at)))
        return vals[-1][1]

    trainer.train_step, trainer.validate = step, validate
    trainer.train()
    return trainer, steps, vals, {k: (v, named[k]) for k, v in before.items()}


@pytest.mark.parametrize(
    "config,mode,bf16,net,per_step", _TRAINER_RUNS,
    ids=[f"{c[:-4]}{'_L' if n else ''}"
         f"{'' if m is None else '_bf16' if b else '_f32'}"
         for c, m, b, n, _ in _TRAINER_RUNS])
def test_trainer_runs_on_card(cuda, tmp_path, config, mode, bf16, net,
                              per_step):
    """The port's ``Trainer`` on the card (±8, offsets randomised), 4
    iterations at batch 2: each step launches the model's kernels as its
    routing gives them (the GAN's D runs none), its losses are finite, the
    GAN recipes never gate G off, every parameter of G and D moves; the
    debug and smoke configs validate (finite PSNR) and write G (and D)
    at 2, 4 and the end, and the GAN debug config resumes from step 2's
    state (G, D, both optimizers and schedulers) on to step 4."""
    import math
    import os

    from realvsr_tpu_torch.train.trainer import Trainer

    opt = _trainer_opt(config, str(tmp_path), mode, bf16, net, niter=4)
    trainer, steps, vals, params = _run_trainer(opt)
    assert len(steps) == 4
    for launches, logs in steps:
        assert launches == per_step
        assert all(torch.isfinite(v).all() for v in logs.values()), logs
        if mode and trainer.is_gan:
            assert logs["g_active"].item() == 1.0
    assert not [k for k, (a, p) in params.items() if torch.equal(a, p)]
    nets = "GD" if trainer.is_gan else "G"
    models = set(os.listdir(opt["path"]["models"]))
    assert {f"latest_{n}.pth" for n in nets} <= models
    if mode:
        return
    assert [a for a, _ in vals] == [2, 4]
    assert all(math.isfinite(p) for _, p in vals)
    assert {f"{s}_{n}.pth" for s in (2, 4) for n in nets} <= models
    if not trainer.is_gan:
        return
    opt = _trainer_opt(config, str(tmp_path), mode, bf16, net, niter=4)
    opt["path"]["resume_state"] = os.path.join(
        opt["path"]["training_state"], "2.state")
    resumed = Trainer(opt, device="cuda", dcn_max_offset=8.0)
    assert resumed.state.step == 2
    assert [s.last_epoch for s in resumed.state.schedulers] == [2, 2]
    d2 = torch.load(os.path.join(opt["path"]["models"], "2_D.pth"),
                    weights_only=True)
    for k, v in resumed.model_d.state_dict().items():
        assert torch.equal(v.cpu(), d2[k]), k
    assert resumed.train().step == 4


def test_one_nccl_rank_split_step_and_trainer_on_card(cuda, tmp_path):
    """One rank over NCCL (torchrun's environment, world 1;
    ``tests/torch_parallel_worker.py``): a Split step of EDVR_NoUp (nf 64,
    8 groups, 1 + 1 ResBlocks, ±8, offsets randomised) on a global batch of
    4 at 48x48 against one process's step on the card, each gradient within
    5e-2 of its largest and each parameter within 2 LR; then the nf 16
    debug config's Trainer on that rank to its last step, rank 0 writing
    the checkpoints."""
    import json

    import yaml

    from torch_parallel_worker import launch, wait

    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_train_step

    opt = _recipe_opt(*_MODELS["edvr_noup"])
    opt["augment"] = None
    ref = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(0))
    _randomise_offsets(ref, 1)
    torch.save({"G": ref.state_dict()}, tmp_path / "init.pt")
    rng = np.random.default_rng(2)
    batch = {k: rng.random((4, 3, 48, 48, 3)).astype(np.float32)
             for k in ("LQs", "GT")}
    np.savez(tmp_path / "batch.npz", **batch)
    wait(launch(tmp_path, "step", dict(
        opt=opt, init=str(tmp_path / "init.pt"), max_offset=8,
        batch=str(tmp_path / "batch.npz"), out=str(tmp_path / "step"),
        device="cuda", backend="nccl"), world=1))
    model = define_g(opt, device=cuda, dcn_max_offset=8)
    model.load_state_dict(ref.state_dict())
    make_train_step(model, opt)(create_train_state(model, opt),
                                {k: torch.from_numpy(v).to(cuda)
                                 for k, v in batch.items()},
                                torch.Generator(device=cuda))
    rank = torch.load(tmp_path / "step.0.pt")
    lr = float(opt["train"]["lr_G"])
    for k, p in model.named_parameters():
        g = p.grad.float().cpu()
        err = (rank["grads"][f"G.{k}"].float() - g).abs().max().item()
        assert err <= 5e-2 * g.abs().max().clamp_min(1e-30).item(), k
        assert ((rank["params"][f"G.{k}"].float() - p.detach().float().cpu())
                .abs().max().item() <= 2.0001 * lr), k
    debug = _recipe_opt("debug_EDVR_woTSA_Split_synthetic.yml")
    debug["train"]["niter"] = 8
    (tmp_path / "debug.yml").write_text(yaml.safe_dump(debug))
    wait(launch(tmp_path, "train", dict(
        opt=str(tmp_path / "debug.yml"), root=str(tmp_path / "run"),
        out=str(tmp_path / "train"), device="cuda", backend="nccl"),
        world=1))
    res = json.loads((tmp_path / "train.0.json").read_text())
    # the loop's counter ends one past the last step, as on the CPU
    assert res["step"] == 9 and "save_network" in res["saves"]


# the largest a gradient that is zero in exact arithmetic may read, of its
# model's largest gradient
_ZERO_GRAD = 1e-3


def test_two_rank_gan_step_on_card_matches_one_process(cuda, tmp_path,
                                                       monkeypatch):
    """Two ``gloo`` ranks sharing the card take one GAN-Split step of the
    GAN recipe (``ragan``, D's BatchNorms; G at nf 64, 8 groups, 1 + 1
    ResBlocks, ±8, offsets randomised; D at nf 64) on their halves of a
    global batch of 4 at 64x64: their parameters and D's running
    statistics are bit-identical, and G's and D's gradients and D's running
    statistics equal one process's step of the whole batch on the card
    within 1e-2 of each tensor's largest plus twice that process's own
    change when the batch is reordered (rounding alone, as
    ``test_torch_parallel.py`` holds the CPU's ranks).  The gradients that
    are zero in exact arithmetic, of a conv bias that feeds a BatchNorm
    (the mean removes it) and of D's output biases (the relativistic loss
    takes the other batch's mean logit off each), are rounding on both
    sides: each is held under ``_ZERO_GRAD`` of its model's largest
    gradient instead.  The one process takes the BatchNorm
    statistics with the ranks' formula (``_global_batch_norm``) rather
    than cuDNN's: the two round apart, and a LeakyReLU input that rounds
    to the other side of 0 moves D's output conv's gradient by ~1e-2 of
    its largest (``test_v2_discriminator_input_grad_on_card_matches_cpu``).
    """
    from torch_parallel_worker import launch, wait

    from realvsr_tpu_torch.models import common, define_d, define_g
    from realvsr_tpu_torch.train.gan import create_gan_train_state
    from realvsr_tpu_torch.train.wrappers import make_train_step

    opt = _recipe_opt("train_EDVR-GAN_woTSA_RealVSR_YCbCr_Split.yml",
                      dict(front_RBs=1, back_RBs=1))
    opt["augment"] = None
    g = define_g(opt, device="cpu", dcn_max_offset=8, generator=_gen(12))
    _randomise_offsets(g, 13)
    d = define_d(opt, device="cpu", generator=_gen(14))
    init = {"G": g.state_dict(), "D": d.state_dict()}
    torch.save(init, tmp_path / "init.pt")
    batch = {k: v.numpy() for k, v in _batch(opt, 64, "Synthetic",
                                             n_items=4).items()}
    np.savez(tmp_path / "batch.npz", **batch)
    procs = launch(tmp_path, "step", dict(
        opt=opt, init=str(tmp_path / "init.pt"), max_offset=8,
        batch=str(tmp_path / "batch.npz"), out=str(tmp_path / "gan"),
        device="cuda"))
    wait(procs)

    def one_process(order):
        gm = define_g(opt, device=cuda, dcn_max_offset=8)
        gm.load_state_dict(init["G"])
        dm = define_d(opt, device=cuda)
        dm.load_state_dict(init["D"])
        make_train_step(gm, opt)(create_gan_train_state(gm, dm, opt),
                                 {k: torch.from_numpy(v[order]).to(cuda)
                                  for k, v in batch.items()},
                                 torch.Generator(device=cuda))
        out = {f"G.{k}": p.grad for k, p in gm.named_parameters()}
        out.update({f"D.{k}": p.grad for k, p in dm.named_parameters()})
        out.update({f"D.{k}": t for k, t in dm.named_buffers()
                    if "running" in k})
        return {k: v.float().cpu() for k, v in out.items()}

    # a world of one with the ranks' BatchNorm (its sums reduce to
    # themselves)
    monkeypatch.setattr(common, "world_size", lambda: 2)
    one, reordered = one_process([0, 1, 2, 3]), one_process([2, 3, 0, 1])
    ranks = [torch.load(tmp_path / f"gan.{r}.pt") for r in range(2)]
    for part in ("params", "stats"):
        for k, v in ranks[0][part].items():
            assert torch.equal(v, ranks[1][part][k]), k
    got = dict(ranks[0]["grads"], **ranks[0]["stats"])
    tops = {}
    for k, v in one.items():
        m = k.split(".")[0]
        tops[m] = max(tops.get(m, 0.0), v.abs().max().item())
    for k, v in one.items():
        pre, _, leaf = k.rpartition(".")
        if k.endswith("conv_out.bias") or (
                leaf == "bias" and ".conv" in pre
                and pre.replace(".conv", ".bn") + ".weight" in one):
            top = tops[k.split(".")[0]]
            sides = (got[k].abs().max().item(), v.abs().max().item())
            print(f"{k}: ranks {sides[0] / top:.3e}, one process "
                  f"{sides[1] / top:.3e} of the model's largest")
            assert max(sides) <= _ZERO_GRAD * top, k
            continue
        err = (got[k].float() - v).abs().max().item()
        spread = (reordered[k] - v).abs().max().item()
        assert err <= 1e-2 * v.abs().max().clamp_min(1e-30).item() \
            + 2 * spread, k


def test_two_rank_spatial_sharded_forward_on_card_matches_full_frame(
        cuda, tmp_path):
    """``eval/spatial.py::spatial_sharded_forward`` of EDVR_NoUp (nf 64, 8
    groups, 1 + 1 ResBlocks, ±4, offsets randomised, f32) on two ``gloo``
    ranks sharing the card, default halo, at 416x64: each rank launches one
    forward's kernels on its rows, both return the full frame, within 1e-3
    of its largest of the unsharded forward on the card (cuDNN's strided
    convs may pick other algorithms for the shard windows)."""
    import json

    from torch_parallel_worker import launch, wait

    from realvsr_tpu_torch.eval.spatial import default_halo

    opt, model = _model("edvr_noup", "cpu", seed=56)
    _randomise_offsets(model, 57)
    torch.save({"G": model.state_dict()}, tmp_path / "init.pt")
    window = torch.rand(1, 3, 416, 64, 3, generator=_gen(58))
    np.savez(tmp_path / "window.npz", window=window.numpy())
    model = model.to(cuda).eval()
    halo = default_halo(model)
    wait(launch(tmp_path, "spatial", dict(
        opt=opt, init=str(tmp_path / "init.pt"), max_offset=4, halo=halo,
        batch=str(tmp_path / "window.npz"), out=str(tmp_path / "sp"),
        device="cuda", backend="gloo")))
    with torch.inference_mode():
        full = model(window.to(cuda)).cpu()
    outs = [torch.load(tmp_path / f"sp.{r}.pt") for r in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == full.shape
    assert (outs[0] - full).abs().max() <= 1e-3 * full.abs().max()
    want = {k: _FORWARD["edvr_noup"][k]
            for k in ("dcn_fwd", "conv3x3", "conv3x3_fused")}
    for r in range(2):
        assert json.loads((tmp_path / f"sp.{r}.json").read_text()) == want


def test_dcn_clamp_check_on_card(cuda):
    """``tools/validate_dcn_clamp.validate`` of the exact flagship (f32,
    cut depth, offset convs of std 3: offsets past ±8) on a 3-frame 64x128
    window at ±4 and ±8: one exact forward (4 ``dcn_fwd``) and one
    block-API forward a radius (4 ``dcn_block`` each), every conv on its
    kernel; the PSNRs finite."""
    import math

    from realvsr_tpu_torch.tools.validate_dcn_clamp import validate

    model = _flagship(cuda, torch.float32, max_offset=None, std=3.0)
    window = torch.rand(1, 3, 64, 128, 3, generator=_gen(59)).to(cuda)
    before = _launches()
    res = validate(model, window, (4, 8))
    fwd = _FORWARD["edvr_noup"]
    assert _since(before) == _counts(4, 3 * fwd["conv3x3"],
                                     3 * fwd["conv3x3_fused"], block=8)
    assert all(math.isfinite(v) for v in res["psnr_db"].values())


@pytest.mark.parametrize("config", ["test_EDVR_woTSA_RealVSR_wi_GT.yml",
                                    "test_synthetic_motion_wi_GT.yml"],
                         ids=["realvsr", "synthetic_motion"])
def test_test_wi_gt_cli_on_card_matches_cpu(cuda, tmp_path, monkeypatch,
                                            config):
    """``tools/test_wi_gt.py`` (its ``main``, as the command line runs it)
    with the config's network (EDVR_NoUp, nf 64, cut to 1 + 1 ResBlocks)
    and seeded weights (offsets of a few pixels) saved as its
    ``pretrain_model_G``, on a 3-frame 64x128 GT / LQ clip from
    ``dump_synthetic_testset``: in bf16 at ±4 each window launches the
    model's kernels and the PSNR and SSIM are finite; in f32 the card's
    PSNR and SSIM equal the CPU's within 1e-2 dB and 1e-3."""
    import math
    import os

    import yaml

    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.tools import _cli, test_wi_gt
    from realvsr_tpu_torch.tools.dump_synthetic_testset import dump

    # results (the log) under tmp_path instead of the checkout
    monkeypatch.setattr(_cli, "parse", lambda path, is_train: parse(
        path, is_train=is_train, root=str(tmp_path)))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "test", config)) as f:
        opt = yaml.safe_load(f)
    opt["network_G"].update(front_RBs=1, back_RBs=1)
    model = define_g(opt, device="cpu", generator=_gen(60))
    _randomise_offsets(model, 61)
    torch.save(model.state_dict(), tmp_path / "G.pth")
    data = str(tmp_path / "data")
    dump(data, num_seqs=1, frames=3, height=64, width=128)
    opt["datasets"]["test"].update(dataroot_LQ=os.path.join(data, "LQ"),
                                   dataroot_GT=os.path.join(data, "GT"))
    opt["path"]["pretrain_model_G"] = str(tmp_path / "G.pth")
    yml = tmp_path / "test.yml"
    yml.write_text(yaml.safe_dump(opt))

    def run(*argv):
        return test_wi_gt.main(["-opt", str(yml), *argv])

    before = _launches()
    res = run("--device", "cuda", "--dtype", "bfloat16", "--max_offset", "4")
    assert _since(before) == {k: 3 * v
                              for k, v in _FORWARD["edvr_noup"].items()}
    assert all(math.isfinite(res[k]) for k in ("psnr", "ssim"))
    card = run("--device", "cuda", "--dtype", "float32")
    cpu = run("--device", "cpu", "--dtype", "float32")
    assert abs(card["psnr"] - cpu["psnr"]) <= 1e-2
    assert abs(card["ssim"] - cpu["ssim"]) <= 1e-3


# ---- The benchmark cells' own runs (BENCHMARK.json, portbench/) ----------

def _cell(config, traffic):
    """(configuration, traffic) of a benchmark cell, as ``portbench/``
    reads them."""
    import json

    with open(f"portbench/configs/{config}.json") as f, \
            open(f"portbench/traffic/{traffic}.json") as g:
        return json.load(f), json.load(g)


@pytest.mark.parametrize("config", ["edvr_noup", "edvr_l"])
def test_restore_cell_launches_at_full_size(cuda, config):
    """The restore entry (``tools/_cli.py::restorer``) as the cell
    ``<config>.restore_clips`` builds it: the configuration's network
    whole on its seeded weights (``portbench/weights.py``), bf16, ±4, on
    one of the cell's clips (50 frames at its frame size): from just
    before the clip to its last frame it launches 50 windows of the
    recipe's forward (``_RECIPE_FORWARD``), and hands every frame back in
    order, finite, at the output's size."""
    import argparse

    from portbench.drivers.restore import make_clips
    from portbench.reference import family
    from portbench.weights import make_params
    from realvsr_tpu_torch.models import define_g
    from realvsr_tpu_torch.tools import _cli

    cfg, tr = _cell(config, "restore_clips")
    net, bf = cfg["network_G"], torch.bfloat16
    opt = {"network_G": net, "scale": cfg["scale"],
           "datasets": {"test": {"padding": "replicate"}}}
    model = define_g(opt, device=cuda, dtype=bf, dcn_max_offset=4)
    model.load_state_dict(make_params(family(cfg["reference"]).param_specs(
        net), 0, cuda, bf, cfg["offset_gain"]), strict=True)
    restore = _cli.restorer(argparse.Namespace(
        streaming=False, flip_test=False, tile=None, overlap=0), opt, model)
    (h, w), s = cfg["restore_size"], cfg["scale"]
    clip = make_clips(2, dict(tr, clips=1), h, w, cuda)[0]
    t = tr["frames_per_clip"]
    before = _launches()
    got = list(restore(clip))
    assert _since(before) == {k: t * v for k, v in
                              _RECIPE_FORWARD[config].items()}
    assert [i for i, _ in got] == list(range(t))
    for _, out in got:
        assert out.shape == (h * s, w * s, 3) and np.isfinite(out).all()


def test_recurrent_restore_cell_launches_at_full_size(cuda):
    """The recurrent restore entry as the cell
    ``basicvsrpp.restore_reds4`` builds it: BasicVSR++ whole on the cell's
    seeded weights and gains, bf16, exact offsets, on one of its clips (100
    frames at 320x180).  A second restore of the clip (its size's graphs
    captured by the first) launches: ``feat_extract``'s 10 ResBlock convs;
    a branch's first step eagerly (its backbone: the input conv and 14
    ResBlock convs), its second (two 64-wide offset convs, the 64 -> 432
    one, the DCN, the backbone), and the DCN alone at each later step (its
    offset convs and backbone replayed); each frame's reconstruction (12
    convs at 64 outputs, the two pixel-shuffle convs and conv_last).  The
    frames equal the model's eager ``forward`` bit for bit, at the output's
    size."""
    import argparse

    from portbench.drivers.restore import make_clips
    from realvsr_tpu_torch.tools import _cli

    cfg, tr = _cell("basicvsrpp", "restore_reds4")
    model = _basicvsrpp(cuda, num_blocks=cfg["network_G"]["num_blocks"],
                        seed=0)
    model.dtype = torch.bfloat16
    opt = {"network_G": cfg["network_G"], "scale": cfg["scale"],
           "datasets": {"test": {}}}
    restore = _cli.restorer(argparse.Namespace(
        streaming=False, flip_test=False, tile=None, overlap=0), opt, model)
    (h, w), t = cfg["restore_size"], tr["frames_per_clip"]
    clip = make_clips(2, dict(tr, clips=1), h, w, cuda)[0]
    first = [out for _, out in restore(clip)]
    before = _launches()
    got = list(restore(clip))
    assert _since(before) == _counts(dcn=4 * (t - 1),
                                     conv=10 + 4 * (15 + 17) + 12 * t,
                                     fused=4 + 3 * t)
    assert [i for i, _ in got] == list(range(t))
    for (_, out), again, want in zip(got, first, _eager(model, clip, cuda)):
        assert out.shape == (4 * h, 4 * w, 3)
        assert np.array_equal(out, want) and np.array_equal(again, want)


def test_trainer_at_the_training_cells_batch_on_card(cuda, tmp_path):
    """The ``Trainer`` as the cell ``edvr_noup.train_split`` builds it
    (``portbench/drivers/train.py::trainer_opt``: the Split recipe at batch
    32 of 192x192 3-frame crops, f32, ±8, the cell's seeded weights) on its
    stand-in synthetic set: each of an epoch's 2 steps launches one
    forward's and one DCN backward's kernels at the recipe's depth, with
    finite losses, and every parameter moves."""
    from portbench.drivers.train import trainer_opt
    from portbench.reference import family
    from portbench.weights import make_params
    from realvsr_tpu_torch.train.trainer import Trainer

    cfg, tr = _cell("edvr_noup", "train_split")
    trainer = Trainer(trainer_opt(cfg, tr, 0, str(tmp_path)), device=cuda,
                      dcn_max_offset=tr["dcn_max_offset"])
    params = make_params(family(cfg["reference"]).param_specs(
        cfg["network_G"]), 0, cuda, torch.float32, cfg["offset_gain"])
    trainer.model.load_state_dict(params, strict=True)
    batches = list(trainer.train_loader.epoch_iter(0))
    assert len(batches) == 2
    for batch in batches:
        before = _launches()
        trainer.state, logs = trainer.train_step(
            trainer.state, {k: torch.from_numpy(batch[k]).to(cuda)
                            for k in ("LQs", "GT")}, trainer.gen)
        assert _since(before) == _step(_RECIPE_FORWARD["edvr_noup"])
        assert all(torch.isfinite(v).all() for v in logs.values()), logs
    for k, p in trainer.model.named_parameters():
        assert not torch.equal(p.detach(), params[k]), k
