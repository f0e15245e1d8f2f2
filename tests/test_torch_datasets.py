"""The RealVSR and Vimeo90K datasets of the port against the JAX package's
on the CPU, on fixtures the tests write (PNG folders and an LMDB pair):
for the same ``rng`` an item equals the JAX item exactly (both decode the
same files with cv2 and draw the same numbers).  Also the port's lmdb_lite
(a copy of the JAX package's) against the JAX reader, and GT sharpening.
"""
import pickle

import cv2
import numpy as np
import pytest

from realvsr_tpu.data import lmdb_lite as jax_lmdb
from realvsr_tpu.data import realvsr as jreal
from realvsr_tpu.data import vimeo90k as jvimeo
from realvsr_tpu.data.sharpen import sharpen_gt as jax_sharpen_gt
from realvsr_tpu_torch.data import create_dataset, lmdb_lite
from realvsr_tpu_torch.data.sharpen import sharpen_gt

H, W, FRAMES = 20, 24, 8
SEQS = ("000", "001", "008")  # 008 is in the hard-coded test split


@pytest.fixture(scope="module")
def realvsr_root(tmp_path_factory):
    """GT and LQ trees of 3 sequences x 8 frames, as PNG folders and as
    LMDB environments of raw uint8 buffers; the keys and remove pickles."""
    root = tmp_path_factory.mktemp("realvsr")
    rng = np.random.default_rng(0)
    keys, buffers = [], {"GT": [], "LQ": []}
    for seq in SEQS:
        for f in range(FRAMES):
            key = f"{seq}_{f:05d}"
            keys.append(key)
            for side in ("GT", "LQ"):
                img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
                d = root / side / seq
                d.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(d / f"{f:05d}.png"), img)
                buffers[side].append((key.encode("ascii"), img.tobytes()))
    for side, items in buffers.items():
        lmdb_lite.write_lmdb(str(root / f"{side}.lmdb"), items)
    with open(root / "keys.pkl", "wb") as f:
        pickle.dump({"keys": keys}, f)
    with open(root / "remove.pkl", "wb") as f:
        pickle.dump(["001"], f)
    return root


REALVSR_CASES = {  # name: options over the base
    "centre": dict(),
    "flip_rot_reverse": dict(use_flip=True, use_rot=True,
                             random_reverse=True, interval_list=[1, 2]),
    "border_mode": dict(border_mode=True, random_reverse=True,
                        use_flip=True),
    "remove_list_y": dict(remove_list="remove.pkl", color="y",
                          use_rot=True),
    "val_phase": dict(phase="val"),
}


def _realvsr_opt(root, mode, backend, case):
    opt = dict(mode=mode, phase="train", N_frames=3, GT_size=12,
               interval_list=[1], random_reverse=False, border_mode=False,
               dataroot_GT=str(root / ("GT.lmdb" if backend == "lmdb"
                                       else "GT")),
               dataroot_LQ=str(root / ("LQ.lmdb" if backend == "lmdb"
                                       else "LQ")),
               cache_keys=str(root / "keys.pkl"), max_frame_idx=FRAMES - 1,
               img_shape=(3, H, W), scale=1)
    opt.update(REALVSR_CASES[case])
    if opt.get("remove_list"):
        opt["remove_list"] = str(root / opt["remove_list"])
    return opt


def _same_items(ours, ref, indices, seeds):
    for index in indices:
        for seed in seeds:
            a = ours.get(index, np.random.default_rng(seed))
            b = ref.get(index, np.random.default_rng(seed))
            assert a.keys() == b.keys() and a["key"] == b["key"]
            for k in ("LQs", "GT"):
                assert a[k].dtype == np.float32 and a[k].flags.c_contiguous
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("case", list(REALVSR_CASES))
@pytest.mark.parametrize("backend", ["img", "lmdb"])
@pytest.mark.parametrize("mode", ["RealVSR", "RealVSR_AllPair"])
def test_realvsr_items_match_jax(realvsr_root, mode, backend, case):
    opt = _realvsr_opt(realvsr_root, mode, backend, case)
    ours = create_dataset(opt)
    ref = (jreal.RealVSRAllPairDataset if mode.endswith("AllPair")
           else jreal.RealVSRDataset)(opt)
    assert ours.keys == ref.keys
    removed = "001" if opt.get("remove_list") else "008"
    assert len(ours) == 2 * FRAMES
    assert not any(k.startswith(removed) for k in ours.keys)
    assert ours.all_pair == mode.endswith("AllPair")
    _same_items(ours, ref, (0, 3, 7, 12), (0, 1, 5))
    item = ours[7]
    c = 1 if opt.get("color") == "y" else 3
    size = 12 if opt["phase"] == "train" else None
    lq_hw = (size, size) if size else (H, W)
    assert item["LQs"].shape == (3, *lq_hw, c)
    assert item["GT"].shape == ((3, *lq_hw, c) if ours.all_pair
                                else (*lq_hw, c))


def test_realvsr_lmdb_equals_the_png_folders(realvsr_root):
    img = create_dataset(_realvsr_opt(realvsr_root, "RealVSR_AllPair", "img",
                                      "flip_rot_reverse"))
    lmdb = create_dataset(_realvsr_opt(realvsr_root, "RealVSR_AllPair",
                                       "lmdb", "flip_rot_reverse"))
    assert lmdb.data_type == "lmdb" and img.data_type == "img"
    _same_items(img, lmdb, (2, 9), (3,))


def test_realvsr_requires_the_keys_pickle(realvsr_root):
    opt = _realvsr_opt(realvsr_root, "RealVSR", "img", "centre")
    opt["cache_keys"] = None
    with pytest.raises(ValueError, match="cache_keys"):
        create_dataset(opt)


@pytest.fixture(scope="module")
def vimeo_root(tmp_path_factory):
    """Two septuplets: GT at 32x40, LQ at the same size and at x1/4."""
    root = tmp_path_factory.mktemp("vimeo")
    rng = np.random.default_rng(1)
    keys = ["00001_0001", "00002_0003"]
    for key in keys:
        a, b = key.split("_")
        for v in range(1, 8):
            for side, (h, w) in (("GT", (32, 40)), ("LQ", (32, 40)),
                                 ("LQx4", (8, 10))):
                d = root / side / a / b
                d.mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(d / f"im{v}.png"),
                            rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    with open(root / "keys.pkl", "wb") as f:
        pickle.dump({"keys": keys}, f)
    return root


VIMEO_CASES = {  # name: (LQ tree, scale, GT_size, LQ_size, N, options)
    "same_size": ("LQ", 1, 16, None, 7, dict(use_flip=True, use_rot=True)),
    "lr_input_x4": ("LQx4", 4, 16, 4, 5, dict(use_flip=True, use_rot=True,
                                              random_reverse=True)),
    "val_phase": ("LQ", 1, 16, None, 3, dict(phase="val")),
}


@pytest.mark.parametrize("case", list(VIMEO_CASES))
@pytest.mark.parametrize("mode", ["Vimeo90K", "Vimeo90K_AllPair"])
def test_vimeo90k_items_match_jax(vimeo_root, mode, case):
    lq, scale, gt_size, lq_size, n, extra = VIMEO_CASES[case]
    opt = dict(mode=mode, phase="train", N_frames=n, GT_size=gt_size,
               LQ_size=lq_size, scale=scale, random_reverse=False,
               dataroot_GT=str(vimeo_root / "GT"),
               dataroot_LQ=str(vimeo_root / lq),
               cache_keys=str(vimeo_root / "keys.pkl"))
    opt.update(extra)
    ours = create_dataset(opt)
    ref = (jvimeo.Vimeo90KAllPairDataset if mode.endswith("AllPair")
           else jvimeo.Vimeo90KDataset)(opt)
    assert ours.keys == ref.keys and ours.frame_list == ref.frame_list
    _same_items(ours, ref, (0, 1), (0, 2, 9))
    item = ours[1]
    if opt["phase"] == "train":
        lq_hw, gt_hw = (gt_size // scale,) * 2, (gt_size,) * 2
    else:
        lq_hw = gt_hw = (32, 40)
    assert item["LQs"].shape == (n, *lq_hw, 3)
    assert item["GT"].shape == ((n, *gt_hw, 3) if ours.all_pair
                                else (*gt_hw, 3))


def test_lmdb_lite_round_trip_against_the_jax_reader(tmp_path):
    """Written by the port, read by both; written by the JAX package, read
    by the port: branch and overflow pages included."""
    rng = np.random.default_rng(2)
    items = {f"{i:06d}".encode(): rng.integers(
        0, 256, 9000 if i % 13 == 0 else 30 + i % 200,
        dtype=np.uint8).tobytes() for i in range(900)}
    for writer, name in ((lmdb_lite, "port.lmdb"), (jax_lmdb, "jax.lmdb")):
        path = str(tmp_path / name)
        writer.write_lmdb(path, items.items())
        for reader in (lmdb_lite, jax_lmdb):
            with reader.open(path) as env:
                assert env.entries == len(items)
                with env.begin() as txn:
                    assert dict(txn.cursor()) == items
                    assert txn.get(b"missing") is None
    with pytest.raises(ValueError, match="duplicate"):
        lmdb_lite.write_lmdb(str(tmp_path / "d.lmdb"),
                             [(b"a", b"1"), (b"a", b"2")])


@pytest.mark.parametrize("seed", range(6))
def test_sharpen_gt_matches_jax(seed):
    """Both unsharp variants (the draw picks one per seed) and the
    threshold, equal to the JAX package's for the same generator."""
    img = cv2.resize(np.random.default_rng(3).integers(
        0, 256, (12, 16, 3), dtype=np.uint8), (48, 40))
    ours = sharpen_gt(img, np.random.default_rng(seed))
    ref = jax_sharpen_gt(img, np.random.default_rng(seed))
    assert ours.dtype == np.uint8 and ours.shape == img.shape
    np.testing.assert_array_equal(ours, ref)
    assert not np.array_equal(ours, img)
    np.testing.assert_array_equal(
        sharpen_gt(img, np.random.default_rng(seed), threshold=0.0), img)
