"""``realvsr_tpu_torch/utils/util.py`` against ``realvsr_tpu/utils/util.py``
on the same numpy inputs (f32 on both sides): the image / tensor
conversions, the crops, DUF downsampling at scales 2, 3 and 4 (within
1e-6, and scale 3's ``3 - dim % 3`` extension of ``tests/test_aux.py``),
the experiment archival, seeding, the progress bar and the video helpers'
errors."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.utils import util as ju
from realvsr_tpu_torch.utils import util as tu


def test_img2tensor_and_tensor2img_match_jax():
    rng = np.random.default_rng(0)
    img = rng.random((10, 12, 3))
    t = tu.img2tensor(img)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), ju.img2tensor(img))
    x = (rng.random((9, 7, 3)) * 1.4 - 0.2).astype(np.float32)
    for kw in ({}, {"reverse_channel": False},
               {"out_type": np.float32, "min_max": (-0.2, 1.2)}):
        ours = tu.tensor2img(torch.from_numpy(x), **kw)
        ref = ju.tensor2img(x, **kw)
        assert ours.dtype == ref.dtype
        np.testing.assert_array_equal(ours, ref)
    gray = rng.random((5, 6, 1)).astype(np.float32)
    np.testing.assert_array_equal(tu.tensor2img(torch.from_numpy(gray)),
                                  ju.tensor2img(gray))


def test_crop_border_and_modcrop_match_jax():
    rng = np.random.default_rng(1)
    imgs = [rng.random((20, 18, 3)) for _ in range(2)]
    for px in (0, 3):
        for a, b in zip(tu.crop_border(imgs, px), ju.crop_border(imgs, px)):
            np.testing.assert_array_equal(a, b)
    for img in (rng.random((21, 19, 3)), rng.random((21, 19))):
        for s in (2, 3, 4):
            np.testing.assert_array_equal(tu.modcrop(img, s),
                                          ju.modcrop(img, s))
    with pytest.raises(ValueError):
        tu.modcrop(rng.random((2, 3, 4, 5)), 2)


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("hw", [(24, 30), (25, 31), (27, 33)])
def test_duf_downsample_matches_jax(scale, hw):
    x = np.random.default_rng(2).random((2, *hw, 3)).astype(np.float32)
    ours = tu.duf_downsample(torch.from_numpy(x), scale)
    ref = np.asarray(ju.duf_downsample(jnp.asarray(x), scale))
    assert ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    if scale == 3:   # a full 3 extra rows / columns when divisible
        assert ours.shape[1:3] == tuple(-(-(d + 3 - d % 3) // 3)
                                        for d in hw)
    with pytest.raises(ValueError):
        tu.duf_downsample(torch.from_numpy(x), 5)


def test_mkdir_and_rename_seed_and_progress_bar(tmp_path, capsys):
    d = tmp_path / "exp"
    tu.mkdir_and_rename(str(d))
    (d / "f").write_text("x")
    tu.mkdir_and_rename(str(d))
    assert os.listdir(d) == []
    archived = [p for p in os.listdir(tmp_path) if "_archived_" in p]
    assert len(archived) == 1
    assert os.listdir(tmp_path / archived[0]) == ["f"]
    tu.set_random_seed(3)
    a = (np.random.random(), torch.rand(1).item())
    ju.set_random_seed(3)
    assert np.random.random() == a[0]
    tu.set_random_seed(3)
    assert torch.rand(1).item() == a[1]
    bar = tu.ProgressBar(2)
    bar.update("one")
    bar.update()
    out = capsys.readouterr().out
    assert "[1/2]" in out and "[2/2]" in out and "one" in out
    tu.ProgressBar().update()
    assert "completed 1" in capsys.readouterr().out
    assert len(tu.get_timestamp()) == len(ju.get_timestamp())


def test_video_helpers_raise_clearly(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="ffmpeg binary"):
        tu.encode_video_with_ffmpeg("%05d.png", str(tmp_path / "o.mp4"), 20)
    with pytest.raises(RuntimeError, match="cannot open video"):
        tu.extract_frames_with_ffmpeg(str(tmp_path / "none.mp4"),
                                      str(tmp_path / "frames"))
