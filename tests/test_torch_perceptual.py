"""LPIPS / DISTS (``realvsr_tpu_torch/eval/perceptual.py``) against the JAX
package's ``realvsr_tpu/eval/perceptual.py`` on the CPU in f32, with the
same random VGG16 weights and heads (no download: random weights on both
sides); the torchvision-format state dict round trip; and the port's
``evaluate_metrics`` command line against the JAX package's on a tree of
PNGs the test writes.

Tolerance: 1e-4 relative on the scores (13 f32 convs, sums in other
orders).
"""
import importlib.util
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.eval import perceptual as JP
from realvsr_tpu_torch.convert import (perceptual_params_from_jax,
                                       vgg16_state_dict_from_jax)
from realvsr_tpu_torch.eval import perceptual as P
from realvsr_tpu_torch.tools import evaluate_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """The JAX random init as numpy, and the port's parameters from it."""
    jp = JP.init_lpips_params(with_dists=True)
    host = {"convs": [{n: np.asarray(a) for n, a in c.items()}
                      for c in jp["convs"]]}
    host.update({k: [np.asarray(a) for a in jp[k]]
                 for k in ("lins", "alpha", "beta")})
    return host, P.build_params(perceptual_params_from_jax(host), "cpu")


def _imgs(seed, b=2, h=32, w=48):
    rng = np.random.default_rng(seed)
    x = rng.random((b, h, w, 3), np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    return x, y


def test_random_init_is_the_jax_one(params):
    host, ours = params
    port = P.init_lpips_params(with_dists=True, device="cpu")
    for k, v in ours["vgg16"].state_dict().items():
        assert torch.equal(port["vgg16"].state_dict()[k], v), k
    for key in ("lins", "alpha", "beta"):
        for a, b in zip(port[key], ours[key]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("metric", ["lpips", "dists"])
def test_metric_matches_jax(params, metric):
    host, ours = params
    x, y = _imgs(1)
    ref = np.asarray(getattr(JP, metric)(host, jnp.asarray(x),
                                         jnp.asarray(y)))
    out = getattr(P, metric)(ours, x, y)
    assert out.shape == (2,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4)
    # identical inputs score zero
    same = getattr(P, metric)(ours, x, x)
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-5)


def test_torchvision_format_round_trip(params, tmp_path):
    host, ours = params
    sd = vgg16_state_dict_from_jax(host["convs"])
    # a torchvision vgg16 state dict loads into the backbone strictly
    vgg = P.VGG16Features()
    vgg.load_state_dict(sd, strict=True)
    combined = dict(sd)
    for k in range(5):
        combined[f"lin{k}.model.1.weight"] = torch.from_numpy(
            host["lins"][k].reshape(1, -1, 1, 1).copy())
    for key in ("alpha", "beta"):
        combined[key] = torch.from_numpy(
            np.concatenate(host[key]).reshape(1, -1, 1, 1))
    path = str(tmp_path / "combined.pth")
    torch.save(combined, path)
    lp = P.load_lpips_weights(path, device="cpu")
    dp = P.load_dists_weights(path, device="cpu")
    x, y = _imgs(4, h=16, w=16)
    torch.testing.assert_close(P.lpips(lp, x, y), P.lpips(ours, x, y),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(P.dists(dp, x, y), P.dists(ours, x, y),
                               rtol=1e-6, atol=0)
    # the JAX loader reads the same file into the same scores
    jl = JP.load_lpips_weights(path)
    np.testing.assert_allclose(
        P.lpips(lp, x, y).numpy(),
        np.asarray(JP.lpips(jl, jnp.asarray(x), jnp.asarray(y))), rtol=1e-4)


def _write_tree(root, seed, noise):
    """Two sequences of two 32 x 48 PNG frames: GT and a noisy result."""
    rng = np.random.default_rng(seed)
    for seq in ("000", "001"):
        for t in range(2):
            base = cv2.resize(rng.random((8, 12, 3)), (48, 32),
                              interpolation=cv2.INTER_CUBIC) * 255
            for kind, img in (("gt", base), ("res", base + rng.normal(
                    0, noise, base.shape))):
                d = os.path.join(root, kind, seq)
                os.makedirs(d, exist_ok=True)
                cv2.imwrite(os.path.join(d, f"{t:05d}.png"),
                            np.clip(img, 0, 255).astype(np.uint8))
    return os.path.join(root, "res"), os.path.join(root, "gt")


def _table(text):
    """{sequence: {metric: value}} from a metrics table's lines."""
    rows = {}
    for line in text.splitlines():
        if line.startswith("00") and ":" in line:
            name, rest = line.split(":", 1)
            rows[name] = {kv.split("=")[0]: float(kv.split("=")[1])
                          for kv in rest.split()}
    return rows


def test_evaluate_metrics_cli_matches_the_jax_tool(tmp_path, capsys,
                                                   monkeypatch):
    res, gt = _write_tree(str(tmp_path), 5, 12.0)
    argv = ["--results", res, "--gt", gt, "--metrics", "psnr", "ssim",
            "lpips", "dists"]
    totals = evaluate_metrics.main(argv + ["--device", "cpu"])
    ours = _table(capsys.readouterr().out)
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_metrics", os.path.join(REPO, "tools",
                                             "evaluate_metrics.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr("sys.argv", ["evaluate_metrics.py"] + argv)
    tool.main()
    ref = _table(capsys.readouterr().out)
    assert sorted(ours) == sorted(ref) == ["000", "001"]
    for seq in ref:
        for m in ("psnr", "ssim"):
            assert ours[seq][m] == ref[seq][m], (seq, m)
        for m in ("lpips", "dists"):  # printed to 4 decimals
            assert abs(ours[seq][m] - ref[seq][m]) <= 1e-4 + 1e-4 * abs(
                ref[seq][m]), (seq, m)
    assert set(totals) == {"psnr", "ssim", "lpips", "dists"}
