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

from realvsr_tpu_torch.ops.kernels.check import (conv3x3_plain_grads,
                                                 grad_tolerance, max_abs_err,
                                                 slope_mismatches, tolerance)
from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain
from realvsr_tpu_torch.ops.deform_conv_block import (
    modulated_deform_conv_block)
from realvsr_tpu_torch.ops.kernels.conv3x3 import (chunk, conv3x3,
                                                   conv3x3_autograd,
                                                   conv3x3_fused,
                                                   conv3x3_plain,
                                                   kernel_width, pack_weight,
                                                   pack_weight_cuda,
                                                   round_tf32)
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
    ((2, 37, 45, 16), 16, "relu", True),  # narrow inputs: mma.sync kernel
    ((1, 20, 24, 48), 0, None, True),     # 48 inputs: mma.sync kernel
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
    n = conv3x3.launches
    out = conv3x3(x, wgt, bias, act, res, x2)
    torch.cuda.synchronize()
    assert conv3x3.launches == n + 1
    ref = conv3x3_plain(x, wgt, bias, act, res, x2)
    assert max_abs_err(out, ref) <= tolerance(ref)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cout,cin", [(3, 64), (64, 128), (216, 64),
                                      (256, 128)])
def test_conv3x3_weight_packer_matches_plain(cuda, dtype, cout, cin):
    """The kernel's packer lays the weight out exactly as pack_weight,
    rounded to TF32 for f32."""
    w = torch.randn(cout, cin, 3, 3, generator=_gen(14)).to(cuda, dtype)
    n = kernel_width(cout)
    ref = pack_weight(w, n, chunk(dtype))
    if dtype == torch.float32:
        ref = round_tf32(ref)
    assert torch.equal(pack_weight_cuda(w, n), ref)


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
        dcn_fwd_om(x, torch.zeros(1, 8, 32, 108, device=cuda), w,
                   deformable_groups=4)


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
    ((2, 37, 45, 16), 0, 20, "lrelu", True, True),   # mma.sync: 4 n-tiles
    ((1, 20, 24, 64), 0, 300, None, True, False),    # mma.sync: cout > 256
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
    """C = 32 in 8 groups (and 64 in 4) has no kernel: a ValueError naming
    the ROADMAP, no launch, no plain fallback."""
    x, off, mask, _, _, g = _narrow_inputs((1, 8, 16, 16), torch.float32,
                                           cuda)
    n = (dcn_fwd.launches, dcn_bwd.launches)
    x32 = torch.randn(1, 8, 16, 32, device=cuda)
    w32 = torch.randn(32, 32, 3, 3, device=cuda)
    off8 = torch.zeros(1, 8, 16, 8 * 18, device=cuda)
    mask8 = torch.zeros(1, 8, 16, 8 * 9, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP.md, queue 2"):
        dcn_fwd(x32, off8, mask8, w32, None, 8)
    with pytest.raises(ValueError, match="ROADMAP.md, queue 2"):
        dcn_fwd_om(x32, _om(off8, mask8 + 0.5), w32, None, 8)
    with pytest.raises(ValueError, match="ROADMAP.md, queue 2"):
        dcn_bwd(x32, off8, mask8, w32, torch.zeros_like(x32), 8)
    with pytest.raises(ValueError, match="ROADMAP.md, queue 2"):
        dcn_bwd_om(x32, _om(off8, mask8 + 0.5), w32, torch.zeros_like(x32),
                   8)
    x64 = torch.randn(1, 8, 16, 64, device=cuda)
    with pytest.raises(ValueError, match="ROADMAP.md, queue 2"):
        dcn_fwd(x64, off, mask, torch.randn(64, 64, 3, 3, device=cuda),
                None, 4)
    assert (dcn_fwd.launches, dcn_bwd.launches) == n


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
