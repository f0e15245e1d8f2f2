"""Streaming inference (``realvsr_tpu_torch/eval/streaming.py``) against the
JAX package's ``StreamingRunner`` and against the port's own full model, on
the CPU in f32.

EDVR_NoUp at nf 16, 4 deformable groups, 2 + 2 ResBlocks, 32 x 64 frames;
the JAX params come from ``model.init`` with the zero-initialised DCN offset
convs randomised (numpy seed), so offsets reach a few pixels, and move to
the port through ``state_dict_from_jax``.  Tolerances: 1e-4 against JAX
(f32 sums in other orders through ~20 layers), 2e-5 against the port's
full model (the JAX package's own bound, ``tests/test_streaming.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.eval.streaming import StreamingRunner as JaxRunner
from realvsr_tpu.models.edvr import EDVR as JaxEDVR
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.eval.streaming import StreamingRunner
from realvsr_tpu_torch.models.edvr import EDVR, EDVRNoUp
from realvsr_tpu_torch.models.tdan import TDAN
from realvsr_tpu_torch.utils.indexing import index_generation

CFG = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=2, back_RBs=2,
           predeblur=False, HR_in=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise_offset_convs(params, rng, scale=1.0):
    for lvl in ("L3", "L2", "L1", "cas"):
        c = params["pcd_align"][f"{lvl}_dcnpack"]["conv_offset_mask"]["Conv_0"]
        for name in ("kernel", "bias"):
            c[name] = (rng.normal(size=c[name].shape) * scale).astype(
                np.float32)
    return params


def _pair(jcls, tcls, cfg, seed, hw):
    """The JAX model and params and the port's model with the same
    weights."""
    rng = np.random.default_rng(seed)
    jmodel = jcls(**cfg)
    params = jax.tree.map(np.asarray, jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, *hw, 3)))["params"]))
    params = _randomise_offset_convs(params, rng)
    tmodel = tcls(**cfg, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def noup():
    return _pair(JaxEDVRNoUp, EDVRNoUp, dict(CFG, w_TSA=False), 0, (16, 16))


@pytest.fixture(scope="module")
def jax_runner(noup):
    jmodel, params, _ = noup
    return JaxRunner(jmodel, params, padding="replicate")


def _frames(seed, t=5, h=32, w=64, b=None):
    rng = np.random.default_rng(seed)
    shape = (t, h, w, 3) if b is None else (b, t, h, w, 3)
    return rng.uniform(size=shape).astype(np.float32)


def _close(ours, ref, atol, name=""):
    np.testing.assert_allclose(np.asarray(ours, np.float32),
                               np.asarray(ref, np.float32), atol=atol,
                               err_msg=name)


def test_run_matches_jax_and_the_full_model(noup, jax_runner):
    _, _, tmodel = noup
    frames = _frames(0)
    runner = StreamingRunner(tmodel, padding="replicate", device="cpu")
    ours = runner.run(frames)
    assert ours.shape == (5, 32, 64, 3) and ours.dtype == torch.float32
    _close(ours, jax_runner.run(jnp.asarray(frames)), 1e-4, "vs JAX")
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        for t in range(frames.shape[0]):
            sel = index_generation(t, frames.shape[0], 3, "replicate")
            ref = tmodel(x[sel][None])[0]
            _close(ours[t], ref, 2e-5, f"frame {t}")


def test_run_lazy_matches_jax_and_run(noup, jax_runner):
    _, _, tmodel = noup
    frames = _frames(1, t=4)
    runner = StreamingRunner(tmodel, device="cpu")
    lazy = torch.stack(list(runner.run_lazy(frames)))
    ref = np.stack([np.asarray(o) for o in
                    jax_runner.run_lazy(jnp.asarray(frames))])
    _close(lazy, ref, 1e-4, "vs JAX")
    _close(lazy, runner.run(frames), 1e-6, "vs run")


def test_run_scan_matches_jax_and_run(noup, jax_runner):
    _, _, tmodel = noup
    frames = _frames(2, t=6)
    runner = StreamingRunner(tmodel, device="cpu")
    scan = runner.run_scan(frames)
    _close(scan, jax_runner.run_scan(jnp.asarray(frames)), 1e-4, "vs JAX")
    _close(scan, runner.run(frames), 2e-5, "vs run")


def test_run_scan_clips_matches_jax_and_per_clip(noup, jax_runner):
    _, _, tmodel = noup
    clips = _frames(3, t=4, b=2)
    runner = StreamingRunner(tmodel, device="cpu")
    batched = runner.run_scan_clips(torch.from_numpy(clips))
    assert batched.shape == (2, 4, 32, 64, 3)
    _close(batched, jax_runner.run_scan_clips(jnp.asarray(clips)), 1e-4,
           "vs JAX")
    for b in range(2):
        _close(batched[b], runner.run_scan(clips[b]), 2e-5, f"clip {b}")


def test_edvr_x4_tsa_streaming_matches_jax_and_the_full_model():
    cfg = dict(CFG, w_TSA=True)
    jmodel, params, tmodel = _pair(JaxEDVR, EDVR, cfg, 3, (16, 16))
    frames = _frames(4, t=4, h=16, w=24)
    runner = StreamingRunner(tmodel, device="cpu")
    ours = runner.run(frames)
    assert ours.shape == (4, 64, 96, 3)
    _close(ours, JaxRunner(jmodel, params).run(jnp.asarray(frames)), 1e-4,
           "vs JAX")
    x = torch.from_numpy(frames)
    with torch.inference_mode():
        for t in range(4):
            sel = index_generation(t, 4, 3, "replicate")
            _close(ours[t], tmodel(x[sel][None])[0], 2e-5, f"frame {t}")


def test_runner_refuses_tdan_and_other_scans(noup):
    tdan = TDAN(nf=64, nframes=3, nb_f=1, nb_b=1, device="cpu")
    with pytest.raises(ValueError, match="pyramid"):
        StreamingRunner(tdan, device="cpu")
    runner = StreamingRunner(noup[2], padding="reflection", device="cpu")
    with pytest.raises(ValueError, match="replicate"):
        runner.run_scan(_frames(5, t=3))


def test_evaluation_restores_a_stream_as_the_sliding_window(noup, tmp_path):
    """``restore_wo_gt`` of a stream (the test CLIs' ``--streaming``)
    writes the frames that ``evaluate_wo_gt`` (the sliding window) writes,
    from a PNG tree."""
    import cv2

    from realvsr_tpu_torch.eval.test_wo_gt import (evaluate_wo_gt,
                                                   restore_wo_gt)
    from realvsr_tpu_torch.tools._cli import parse_args, restorer

    _, _, tmodel = noup
    opt = {"datasets": {"test": {}}, "network_G": {"nframes": 3}}

    def cli_restore(*flags):
        return restorer(parse_args(["-opt", "test.yml", *flags], ""), opt,
                        tmodel)

    frames = _frames(6, t=4)
    lq = tmp_path / "lq" / "000"
    lq.mkdir(parents=True)
    for t, f in enumerate(frames):
        cv2.imwrite(str(lq / f"{t:05d}.png"), (f * 255).astype(np.uint8))
    outs = {}
    for streaming in (False, True):
        save = tmp_path / f"out_{streaming}"
        if streaming:
            restore_wo_gt(cli_restore("--streaming"), str(tmp_path / "lq"),
                          save_folder=str(save))
        else:
            evaluate_wo_gt(tmodel, None, str(tmp_path / "lq"), 3,
                           save_folder=str(save))
        outs[streaming] = [cv2.imread(str(p)).astype(int) for p in
                           sorted((save / "000").glob("*.png"))]
    assert len(outs[True]) == len(outs[False]) == 4
    for a, b in zip(outs[True], outs[False]):
        assert np.abs(a - b).max() <= 1  # 2e-5 apart before the rounding
    with pytest.raises(ValueError, match="no flip test"):
        cli_restore("--streaming", "--flip_test")


@pytest.mark.parametrize("flags", [["--streaming"],
                                   ["--tile", "32", "48", "--overlap", "8"]],
                         ids=["streaming", "tile"])
def test_cli_restore_flags_on_cpu(noup, tmp_path, monkeypatch, flags):
    """``python -m realvsr_tpu_torch.tools.test_wi_gt ... --streaming`` /
    ``--tile H W --overlap P`` from a YAML and a .pth give the summary of
    ``restore_wi_gt`` with that restore."""
    import os

    import cv2
    import yaml

    from functools import partial

    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.eval.sliding_window import sliding_window_infer
    from realvsr_tpu_torch.eval.test_wi_gt import restore_wi_gt
    from realvsr_tpu_torch.eval.tiled import make_batched_tiled_forward
    from realvsr_tpu_torch.tools import _cli, test_wi_gt

    monkeypatch.setattr(_cli, "parse", lambda path, is_train: parse(
        path, is_train=is_train, root=str(tmp_path)))
    frames = _frames(7, t=4)
    for sub, noise in (("LQ", 0.0), ("GT", 0.05)):
        d = tmp_path / sub / "000"
        d.mkdir(parents=True)
        for t, f in enumerate(frames):
            img = np.clip(f + noise * np.sin(7 * f), 0, 1)
            cv2.imwrite(str(d / f"{t:05d}.png"), (img * 255).astype(np.uint8))
    pth = str(tmp_path / "G.pth")
    torch.save(noup[2].state_dict(), pth)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "configs", "test",
                           "test_EDVR_woTSA_RealVSR_wi_GT.yml")) as f:
        opt = yaml.safe_load(f)
    opt["network_G"].update(CFG, w_TSA=False)
    opt["datasets"]["test"].update(dataroot_LQ=str(tmp_path / "LQ"),
                                   dataroot_GT=str(tmp_path / "GT"))
    opt["path"]["pretrain_model_G"] = pth
    opt["name"] = "cli_flags"
    yml = tmp_path / "test.yml"
    yml.write_text(yaml.safe_dump(opt))
    ours = test_wi_gt.main(["-opt", str(yml), "--device", "cpu", *flags])
    model = EDVRNoUp(**CFG, w_TSA=False, device="cpu")
    model.load_state_dict(noup[2].state_dict())
    if flags[0] == "--streaming":
        runner = StreamingRunner(model, device="cpu")
        restore = lambda frames: enumerate(  # noqa: E731
            out.float().numpy() for out in runner.run_lazy(frames))
    else:
        restore = partial(sliding_window_infer, make_batched_tiled_forward(
            model, tile_hw=(32, 48), overlap=8, device="cpu"), n_frames=3,
            device="cpu")
    ref = restore_wi_gt(restore, str(tmp_path / "LQ"), str(tmp_path / "GT"),
                        3)
    assert ours == ref
