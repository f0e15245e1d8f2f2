"""The kernel families' bytes and operations, the least times and the
model's operation count, against hand-worked shapes."""
import pytest
import torch

from portbench.reference import edvr
from portbench.roofline import conv3x3, dcn_bwd, dcn_fwd, least_s

BF = torch.bfloat16


def _t(*shape, dtype=BF):
    return torch.zeros(shape, dtype=dtype)


def test_conv3x3_work():
    x, x2, out = _t(2, 8, 8, 64), _t(2, 8, 8, 64), _t(2, 8, 8, 64)
    w, b = _t(64, 128, 3, 3), _t(64)
    got = conv3x3.work({"x": x, "x2": x2, "weight": w, "bias": b,
                        "residual": None}, out)
    px = 2 * 8 * 8
    assert got == ((3 * px * 64 + 64 * 128 * 9 + 64) * 2,
                   2 * px * 9 * 128 * 64, 0, "bfloat16")


def test_dcn_work():
    x, om, w, b = _t(3, 4, 5, 64), _t(3, 4, 5, 216), _t(64, 64, 3, 3), _t(64)
    out, px = _t(3, 4, 5, 64), 3 * 4 * 5
    fwd = dcn_fwd.work({"x": x, "om": om, "weight": w, "bias": b}, out)
    assert fwd == ((px * (64 + 216 + 64) + 64 * 64 * 9 + 64) * 2,
                   2 * px * 9 * 64 * 64, 9 * px * 9 * 64, "bfloat16")
    g = _t(3, 4, 5, 64)
    bwd = dcn_bwd.work({"x": x, "om": om, "weight": w, "g": g},
                       (_t(3, 4, 5, 64), _t(3, 4, 5, 216), _t(64, 64, 3, 3)))
    assert bwd == ((px * (64 + 216 + 64) + px * (64 + 216)
                    + 2 * 64 * 64 * 9) * 2,
                   4 * px * 9 * 64 * 64, 20 * px * 9 * 64, "bfloat16")


@pytest.mark.parametrize("work,want", [
    ((3.35e12, 0, 0, "bfloat16"), 1.0),           # bound by the bytes
    ((0, 989e12 * 2, 0, "bfloat16"), 2.0),        # by the tensor cores
    ((0, 495e12, 0, "float32"), 1.0),             # TF32
    ((1, 1, 67e12 * 3, "float32"), 3.0),          # by the f32 cores
])
def test_least_time(work, want):
    assert least_s(*work) == pytest.approx(want)


def test_model_flops_by_hand():
    net = dict(which_model_G="EDVR_NoUp", nf=16, nc=3, nframes=3, groups=8,
               front_RBs=1, back_RBs=1, w_TSA=False)

    def conv(cin, cout, px, k=3):
        return 2 * cin * k * k * cout * px

    p1, p2, p3 = 3 * 64, 3 * 16, 3 * 4       # 3 frames at 8x8, 4x4, 2x2
    om = 8 * 27
    want = conv(3, 16, p1) + 2 * conv(16, 16, p1)             # front
    want += 2 * conv(16, 16, p2) + 2 * conv(16, 16, p3)       # L2, L3
    want += conv(32, 16, p3) + conv(16, 16, p3)               # PCD L3
    want += conv(16, om, p3) + conv(16, 16, p3)
    for p in (p2, p1):                                        # PCD L2, L1
        want += conv(32, 16, p) + conv(32, 16, p) + conv(16, 16, p)
        want += conv(16, om, p) + conv(16, 16, p) + conv(32, 16, p)
    want += conv(32, 16, p1) + conv(16, 16, p1)               # cascade
    want += conv(16, om, p1) + conv(16, 16, p1)
    want += conv(48, 16, 64, k=1) + 2 * conv(16, 16, 64)      # fusion, back
    want += conv(16, 64, 64) + conv(64, 3, 64)                # head
    assert edvr.model_flops(net, (1, 3, 8, 8, 3)) == want
