"""The port's evaluation path vs the JAX package on a tiny PNG clip, its
command line, and the import boundary of the port package."""
import inspect
import json
import os
import subprocess
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.eval.test_wi_gt import evaluate_wi_gt as jax_evaluate_wi_gt
from realvsr_tpu.eval.test_wo_gt import evaluate_wo_gt as jax_evaluate_wo_gt
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.eval.sliding_window import (
    make_forward, sliding_window_infer)
from realvsr_tpu_torch.eval.test_wi_gt import evaluate_wi_gt
from realvsr_tpu_torch.eval.test_wo_gt import evaluate_wo_gt
from realvsr_tpu_torch.models.edvr import EDVRNoUp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1, back_RBs=1,
           w_TSA=False)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 4-frame 32x64 clip (LQ and a noisier GT) plus JAX params with the
    DCN offset convs randomised."""
    root = tmp_path_factory.mktemp("clip")
    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, size=(32, 64, 3)).astype(np.float64)
    for sub in ("LQ", "GT"):
        (root / sub / "001").mkdir(parents=True)
    for t in range(4):
        frame = np.roll(base, t, axis=1)
        noisy = np.clip(frame + rng.normal(size=frame.shape) * 8, 0, 255)
        cv2.imwrite(str(root / "LQ" / "001" / f"{t:05d}.png"),
                    frame.astype(np.uint8))
        cv2.imwrite(str(root / "GT" / "001" / f"{t:05d}.png"),
                    noisy.astype(np.uint8))
    jmodel = JaxEDVRNoUp(**NET)
    params = jax.tree.map(np.asarray, jax.device_get(jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 64, 3))))["params"])
    for lvl in ("L3", "L2", "L1", "cas"):
        c = params["pcd_align"][f"{lvl}_dcnpack"]["conv_offset_mask"]["Conv_0"]
        c["kernel"] = (rng.normal(size=c["kernel"].shape) * 1.5).astype(
            np.float32)
    return root, jmodel, params


def test_evaluate_wi_gt_equals_jax(clip, tmp_path):
    root, jmodel, params = clip
    lq, gt = str(root / "LQ"), str(root / "GT")
    ref = jax_evaluate_wi_gt(jmodel, params, lq, gt, n_frames=3,
                             save_folder=str(tmp_path / "jax"))
    ours = evaluate_wi_gt(EDVRNoUp(**NET, device="cpu"),
                          state_dict_from_jax(params), lq, gt, n_frames=3,
                          save_folder=str(tmp_path / "torch"))
    assert ours.keys() == ref.keys() and ours["n_clips"] == 1
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-6, abs=1e-9), k
    for t in range(4):
        a = cv2.imread(str(tmp_path / "jax" / "001" / f"{t:05d}.png"))
        b = cv2.imread(str(tmp_path / "torch" / "001" / f"{t:05d}.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_evaluate_wo_gt_equals_jax(clip, tmp_path):
    root, jmodel, params = clip
    lq = str(root / "LQ")
    ref = jax_evaluate_wo_gt(jmodel, params, lq, n_frames=3, flip_test=True,
                             save_folder=str(tmp_path / "jax"))
    ours = evaluate_wo_gt(EDVRNoUp(**NET, device="cpu"),
                          state_dict_from_jax(params), lq, n_frames=3,
                          flip_test=True, save_folder=str(tmp_path / "torch"))
    assert ours["n_frames"] == ref["n_frames"] == 4
    assert ours["frames_per_s"] > 0
    for t in range(4):
        a = cv2.imread(str(tmp_path / "jax" / "001" / f"{t:05d}.png"))
        b = cv2.imread(str(tmp_path / "torch" / "001" / f"{t:05d}.png"))
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1


def test_sliding_window_windows_follow_index_generation():
    frames = np.arange(5, dtype=np.float32).reshape(5, 1, 1, 1) * np.ones(
        (5, 2, 2, 1), np.float32)
    seen = []
    for idx, out in sliding_window_infer(lambda w: w[:, 0, 0, 0].clone(),
                                         frames, 3, device="cpu"):
        seen.append(out.tolist())
    assert seen == [[0, 0, 1], [0, 1, 2], [1, 2, 3], [2, 3, 4], [3, 4, 4]]


def test_cli_test_wi_gt_on_cpu(clip, tmp_path, monkeypatch):
    """``python -m realvsr_tpu_torch.tools.test_wi_gt`` from a YAML and a
    torch .pth gives the library's summary."""
    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.tools import _cli, test_wi_gt

    # results (the log) under tmp_path instead of the checkout
    monkeypatch.setattr(_cli, "parse", lambda path, is_train: parse(
        path, is_train=is_train, root=str(tmp_path)))

    root, _, params = clip
    sd = state_dict_from_jax(params)
    pth = str(tmp_path / "G.pth")
    torch.save({"module." + k: v for k, v in sd.items()}, pth)
    with open(os.path.join(REPO, "configs", "test",
                           "test_EDVR_woTSA_RealVSR_wi_GT.yml")) as f:
        opt = yaml.safe_load(f)
    opt["network_G"].update(NET)
    opt["datasets"]["test"].update(dataroot_LQ=str(root / "LQ"),
                                   dataroot_GT=str(root / "GT"))
    opt["path"]["pretrain_model_G"] = pth
    opt["name"] = "cli_test"
    yml = tmp_path / "test.yml"
    yml.write_text(yaml.safe_dump(opt))
    ours = test_wi_gt.main(["-opt", str(yml), "--device", "cpu"])
    ref = evaluate_wi_gt(EDVRNoUp(**NET, device="cpu"), sd,
                         str(root / "LQ"), str(root / "GT"), n_frames=3)
    assert ours == ref


def test_port_imports_no_jax_and_defaults_to_cuda():
    code = r"""
import importlib, inspect, json, pkgutil, sys
import realvsr_tpu_torch
names = [m.name for m in pkgutil.walk_packages(realvsr_tpu_torch.__path__,
                                               "realvsr_tpu_torch.")]
for n in names:
    importlib.import_module(n)
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.models.edvr import EDVRNoUp
from realvsr_tpu_torch.eval.sliding_window import sliding_window_infer
from realvsr_tpu_torch.tools._cli import parse_args
from realvsr_tpu_torch.train.trainer import Trainer
d = lambda f: inspect.signature(f).parameters["device"].default
print(json.dumps({
    "modules": names,
    "leaked": sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                            "realvsr_tpu")),
    "defaults": [d(EDVRNoUp), d(define_g), d(sliding_window_infer),
                 parse_args(["-opt", "x"], "").device, d(Trainer)],
}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for name in ("models.edvr", "ops.kernels.dcn", "ops.kernels.conv3x3",
                 "ops.pyramid", "losses", "losses.basic", "losses.ssim",
                 "losses.pyramid", "schedules", "data", "data.augments",
                 "data.synthetic", "data.video_test", "data.loader",
                 "train.state", "train.wrappers", "train.checkpoint",
                 "train.trainer", "tools.train"):
        assert f"realvsr_tpu_torch.{name}" in out["modules"], name
    assert out["leaked"] == []
    assert out["defaults"] == ["cuda"] * 5


def test_make_forward_casts_to_model_dtype():
    model = EDVRNoUp(**NET, device="cpu", dtype=torch.float64)
    fwd = make_forward(model)
    out = fwd(torch.rand(3, 8, 16, 3))
    assert out.dtype == torch.float64 and out.shape == (8, 16, 3)
    assert all(p.dtype == torch.float64 for p in model.parameters())
    assert not model.training
    assert inspect.signature(evaluate_wi_gt).parameters.keys() == \
        inspect.signature(jax_evaluate_wi_gt).parameters.keys()
