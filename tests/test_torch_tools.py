"""The port's remaining tools on the CPU.

  * ``tools/orbax_to_pth.py``: JAX variables -> the JAX package's
    ``save_network`` (an Orbax directory) -> ``.pth`` ->
    ``load_state_dict(strict=True)`` -> the same forward as JAX within 1e-4,
    for G (EDVRNoUp) and for D (the debug GAN's multiscale PatchGAN with
    BatchNorm statistics, eval mode); and the port's loader naming the
    converter for a directory.
  * ``realvsr_tpu_torch/tools/prepare_data.py``: every subcommand on a
    fixture tree the test writes, file for file equal to the JAX tool's
    output.
  * ``realvsr_tpu_torch/tools/dump_synthetic_testset.py``: PNGs equal to the
    JAX tool's.
  * ``realvsr_tpu_torch/tools/validate_dcn_clamp.py`` on the CPU at a small
    size: the ±R block forward equals the model clamped at ±R.
  * ``tools/compare_convergence.py`` parsing a log of the port's Trainer,
    and that run's TensorBoard scalars read back.
"""
import filecmp
import importlib.util
import os
import os.path as osp
import sys

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.models import define_d as jax_define_d
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu.ops.pyramid import laplacian_pyramid
from realvsr_tpu.train.checkpoint import save_network as jax_save_network
from realvsr_tpu_torch.models import define_d
from realvsr_tpu_torch.models.edvr import EDVRNoUp
from realvsr_tpu_torch.tools import prepare_data as port_prep
from realvsr_tpu_torch.tools.dump_synthetic_testset import dump
from realvsr_tpu_torch.tools.validate_dcn_clamp import block_dcn, validate
from realvsr_tpu_torch.train.checkpoint import load_network
from torch_jax_params import random_variables

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
NET = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1, back_RBs=1,
           w_TSA=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    """A script of the repo's ``tools/`` directory as a module."""
    spec = importlib.util.spec_from_file_location(
        name, osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _gan_opt():
    with open(osp.join(REPO, "configs", "train",
                       "debug_EDVR-GAN_Split_synthetic.yml")) as f:
        return yaml.safe_load(f)


def test_orbax_to_pth_round_trip_g(tmp_path):
    conv = _script("orbax_to_pth")
    opt = _gan_opt()
    x = np.random.default_rng(0).random((1, 3, 32, 32, 3)).astype(np.float32)
    jmodel = JaxEDVRNoUp(**NET)
    params = random_variables(jmodel, np.random.default_rng(1),
                              jnp.asarray(x))["params"]
    jax_save_network(str(tmp_path), "G", 100, params)
    orbax_dir = str(tmp_path / "100_G")
    with pytest.raises(NotImplementedError, match="orbax_to_pth"):
        load_network(orbax_dir)
    out = str(tmp_path / "100_G.pth")
    conv.main(["-opt", _write(tmp_path, opt), "--ckpt", orbax_dir,
               "--out", out])
    model = EDVRNoUp(**NET, device="cpu").eval()
    model.load_state_dict(load_network(out), strict=True)
    with torch.inference_mode():
        ours = model(torch.from_numpy(x)).numpy()
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    np.testing.assert_allclose(ours, ref, atol=1e-4, rtol=0)


def test_orbax_to_pth_round_trip_d_with_batch_stats(tmp_path):
    conv = _script("orbax_to_pth")
    opt = _gan_opt()
    jd = jax_define_d(opt)
    y = np.random.default_rng(2).random((2, 64, 64, 1)).astype(np.float32)
    levels = laplacian_pyramid(jnp.asarray(y), max_levels=3)[:-1]
    variables = random_variables(jd, np.random.default_rng(3), levels)
    assert variables.get("batch_stats")
    jax_save_network(str(tmp_path), "D", 100, variables)
    out = str(tmp_path / "100_D.pth")
    conv.convert(opt, str(tmp_path / "100_D"), out, discriminator=True)
    d = define_d(opt, device="cpu").eval()
    d.load_state_dict(load_network(out), strict=True)
    with torch.inference_mode():
        ours = d([torch.from_numpy(np.array(v)) for v in levels])
    refs = jd.apply(variables, levels, train=False)
    for a, b in zip(ours, refs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0)


def _write(tmp_path, opt):
    path = tmp_path / "opt.yml"
    path.write_text(yaml.safe_dump(opt))
    return str(path)


def _png_tree(root, layout):
    rng = np.random.default_rng(4)
    for rel in layout:
        os.makedirs(osp.dirname(osp.join(root, rel)), exist_ok=True)
        cv2.imwrite(osp.join(root, rel),
                    (rng.random((24, 20, 3)) * 255).astype(np.uint8))


def _same_tree(a, b):
    files = sorted(osp.relpath(osp.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files and files == sorted(osp.relpath(osp.join(d, f), b)
                                     for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        assert filecmp.cmp(osp.join(a, f), osp.join(b, f), shallow=False), f


def test_prepare_data_subcommands_match_the_jax_tool(tmp_path):
    jax_prep = _script("prepare_data")
    realvsr = tmp_path / "realvsr"
    _png_tree(str(realvsr), [f"{s:03d}/{f:05d}.png" for s in (0, 1)
                             for f in (0, 1)])
    vimeo = tmp_path / "vimeo"
    _png_tree(str(vimeo), [f"00001/{s:04d}/im{f}.png" for s in (1, 2)
                           for f in (1, 2)])
    for side, mod in (("jax", jax_prep), ("port", None)):
        out = tmp_path / side
        argv = [["realvsr-ycbcr", str(realvsr), str(out / "ycbcr")],
                ["realvsr-ycbcr", str(realvsr), str(out / "y"), "--only-y"],
                ["vimeo90k-ycbcr", str(vimeo), str(out / "vimeo_ycbcr")],
                ["realvsr-keys", str(out / "keys.pkl")],
                ["vimeo90k-lr", str(vimeo), str(out / "lr"), "--scale", "2"],
                ["create-lmdb", str(realvsr), str(out / "gt.lmdb")],
                ["create-lmdb", str(realvsr), str(out / "sharp.lmdb"),
                 "--sharpen-gt", "--seed", "3"]]
        os.makedirs(out)
        for a in argv:
            if mod is None:
                port_prep.main(a)
            else:
                old = sys.argv
                sys.argv = ["prepare_data.py", *a]
                try:
                    mod.main()
                finally:
                    sys.argv = old
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_dump_synthetic_testset_matches_the_jax_tool(tmp_path):
    jax_dump = _script("dump_synthetic_testset")
    old = sys.argv
    sys.argv = ["dump_synthetic_testset.py", "--out", str(tmp_path / "jax"),
                "--num_seqs", "2", "--frames", "2", "--height", "32",
                "--width", "48"]
    try:
        jax_dump.main()
    finally:
        sys.argv = old
    dump(str(tmp_path / "port"), num_seqs=2, frames=2, height=32, width=48)
    _same_tree(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_validate_dcn_clamp_on_the_cpu():
    """The ±R block forward of the exact model equals the model built with
    the clamp; the offsets (randomised convs) reach past ±4."""
    gen = torch.Generator().manual_seed(0)
    exact = EDVRNoUp(**NET, device="cpu", generator=gen).eval()
    with torch.no_grad():
        for name, p in exact.named_parameters():
            if "conv_offset_mask" in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 2.0)
    x = torch.rand(1, 3, 32, 48, 3, generator=gen)
    res = validate(exact, x, radii=(4, 8))
    # 72 offsets a pixel of 3 frames at L3, L2, L1 and the cascade
    assert res["offsets"] == 72 * 3 * (8 * 12 + 16 * 24 + 2 * 32 * 48)
    assert res["percentiles_px"][100] > 4 and res["within"][4] < 1
    assert np.isfinite(res["psnr_db"][4]) and res["max_abs_diff"][4] > 0
    clamped = EDVRNoUp(**NET, dcn_max_offset=4, device="cpu").eval()
    clamped.load_state_dict(exact.state_dict())
    with torch.inference_mode():
        with block_dcn(exact, 4):
            got = exact(x)
        ref = clamped(x)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="without dcn_max_offset"):
        validate(clamped, x)


def test_compare_convergence_reads_the_port_log_and_tensorboard(tmp_path):
    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train.trainer import Trainer

    with open(osp.join(REPO, "configs", "train",
                       "debug_EDVR_woTSA_Split_synthetic.yml")) as f:
        opt = yaml.safe_load(f)
    opt.update(name="tb_EDVR_woTSA_Split_synthetic", use_tb_logger=True)
    opt["datasets"]["train"]["GT_size"] = 32
    opt["datasets"]["val"].update(frames_per_seq=3)
    opt["train"].update(niter=4, val_freq=4, T_period=[4, 4], restarts=[4])
    opt["logger"].update(print_freq=1, save_checkpoint_freq=100)
    trainer = Trainer(parse(_write(tmp_path, opt), is_train=True,
                            root=str(tmp_path)),
                      device="cpu", dcn_max_offset=8.0)
    trainer.train()
    log = tmp_path / "experiments" / opt["name"] / "train.log"
    losses, vals, rates = _script("compare_convergence").parse(str(log))
    assert sorted(losses) == [1, 2, 3, 4] and len(rates) == 4
    assert set(losses[4]) == {"l_pix_y", "l_pix_c", "l_pix"}
    assert list(vals) == [4] and np.isfinite(vals[4])

    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(str(tmp_path / "tb_logger" / opt["name"]))
    acc.Reload()
    assert set(acc.Tags()["scalars"]) == {"l_pix_y", "l_pix_c", "l_pix",
                                          "psnr_avg"}
    got = [e.value for e in acc.Scalars("l_pix")]
    assert [e.step for e in acc.Scalars("l_pix")] == [1, 2, 3, 4]
    np.testing.assert_allclose(got, [float(losses[i]["l_pix"])
                                     for i in (1, 2, 3, 4)], rtol=1e-4)
    assert acc.Scalars("psnr_avg")[0].value == pytest.approx(vals[4],
                                                             abs=1e-5)
