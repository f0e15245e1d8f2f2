"""The motion-synthetic data of the port against the JAX package's on the
CPU: the generator's frames, the degraded LQ at scale 1 and 4 (through the
MATLAB-bicubic numpy resize, also held at odd sizes), and both motion
datasets' items and entries.  Both sides are numpy float32 from the same
seeds, so the tolerance is 1e-6.
"""
import numpy as np
import pytest

from realvsr_tpu.data import synthetic as jsyn
from realvsr_tpu.ops.resize import matlab_imresize_np as jax_imresize_np
from realvsr_tpu_torch.data import create_dataset
from realvsr_tpu_torch.data import synthetic as tsyn
from realvsr_tpu_torch.ops.resize import matlab_imresize_np

TOL = 1e-6


@pytest.mark.parametrize("seq,t,h,w", [(0, 0, 48, 64), (3, 5, 40, 56),
                                       (101, 2, 64, 64)])
def test_motion_frame_matches_jax(seq, t, h, w):
    ours = tsyn._motion_frame(seq, t, h, w)
    ref = jsyn._motion_frame(seq, t, h, w)
    assert ours.shape == ref.shape == (h, w, 3) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    # frames move: the next one differs
    assert np.abs(tsyn._motion_frame(seq, t + 1, h, w) - ours).max() > 0.05
    assert not ours.flags.writeable  # cached: callers must not write to it


@pytest.mark.parametrize("scale", [1, 4])
def test_lq_frame_matches_jax(scale):
    ours = tsyn._lq_frame(2, 3, 64, 48, scale)
    ref = jsyn._lq_frame(2, 3, 64, 48, scale)
    assert ours.shape == ref.shape == (64 // scale, 48 // scale, 3)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    assert 0.0 <= ours.min() and ours.max() <= 1.0


@pytest.mark.parametrize("shape,scale", [((37, 45, 3), 0.25),
                                         ((33, 21, 1), 1 / 3),
                                         ((9, 13, 3), 2.0),
                                         ((31, 17, 3), 0.5)])
def test_matlab_imresize_np_matches_jax_at_odd_sizes(shape, scale):
    img = np.random.default_rng(7).random(shape).astype(np.float32)
    ours = matlab_imresize_np(img, scale)
    ref = jax_imresize_np(img, scale)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0, atol=TOL)
    u8 = (img * 255).astype(np.uint8)
    np.testing.assert_allclose(matlab_imresize_np(u8, scale),
                               jax_imresize_np(u8, scale), rtol=0, atol=TOL)


TRAIN = dict(mode="SyntheticMotion", phase="train", N_frames=5, num_seqs=2,
             frames_per_seq=6, frame_h=64, frame_w=48)


@pytest.mark.parametrize("scale,gt_size", [(1, 32), (4, 32)])
def test_motion_train_items_match_jax(scale, gt_size):
    opt = dict(TRAIN, scale=scale, GT_size=gt_size)
    ours = create_dataset(opt)
    ref = jsyn.SyntheticMotionVSRDataset(opt)
    assert ours.keys == ref.keys and len(ours) == 12
    for index in (0, 5, 7, 11):  # border frames clip their neighbours
        a = ours.get(index, np.random.default_rng(index + 10))
        b = ref.get(index, np.random.default_rng(index + 10))
        assert a["key"] == b["key"]
        assert a["LQs"].shape == (5, gt_size // scale, gt_size // scale, 3)
        assert a["GT"].shape == (5, gt_size, gt_size, 3)
        for k in ("LQs", "GT"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)
    np.testing.assert_array_equal(ours[3]["GT"], ref[3]["GT"])


def test_motion_train_rejects_gt_size_off_the_scale_grid():
    with pytest.raises(ValueError, match="multiple of scale"):
        create_dataset(dict(TRAIN, scale=4, GT_size=30))


@pytest.mark.parametrize("scale", [1, 4])
def test_motion_test_items_and_entries_match_jax(scale):
    opt = dict(mode="SyntheticMotionTest", phase="val", N_frames=5,
               num_seqs=2, frames_per_seq=6, frame_h=32, frame_w=48,
               padding="new_info", scale=scale)
    ours = create_dataset(opt)
    ref = jsyn.SyntheticMotionVideoTestDataset(opt)
    assert ours.entries == ref.entries and len(ours) == 12
    assert ours.entries[0] == ("100", 0, 1)  # held-out sequences from 100
    for index in range(len(ours)):
        a, b = ours[index], ref[index]
        assert (a["folder"], a["idx"], a["border"]) == (
            b["folder"], b["idx"], b["border"])
        assert a["LQs"].shape == (5, 32 // scale, 48 // scale, 3)
        assert a["GT"].shape == (32, 48, 3)
        for k in ("LQs", "GT"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=TOL)
