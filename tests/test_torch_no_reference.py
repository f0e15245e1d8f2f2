"""NIQE / BRISQUE (``realvsr_tpu_torch/eval/niqe.py``, ``brisque.py``, the
feature pass in float64 through torch) against the numpy modules of the
JAX package (``realvsr_tpu/eval/niqe.py``, ``brisque.py``) on the CPU, on
seeded natural-image stand-ins of at most 192 x 192; the libsvm round trip;
and the port's ``evaluate_no_reference`` command line against the JAX
package's on a tree of PNGs the test writes.

Both sides are float64.  Tolerances: 1e-6 relative on the features (sums
in other orders: the argmin of the alpha table sees the same values), 1e-4
relative on the scores.
"""
import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch

from realvsr_tpu.eval import brisque as JB
from realvsr_tpu.eval import niqe as JN
from realvsr_tpu_torch.eval import brisque as B
from realvsr_tpu_torch.eval import niqe as N
from realvsr_tpu_torch.tools import evaluate_no_reference

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


def _natural_ish(seed, hw=192, noise=4.0):
    """Smooth random field + texture (``tests/test_no_reference.py``)."""
    rng = np.random.default_rng(seed)
    img = cv2.resize(rng.random((hw // 8, hw // 8)), (hw, hw),
                     interpolation=cv2.INTER_CUBIC)
    return np.clip(img * 200 + rng.normal(0, noise, (hw, hw)), 0, 255)


def _rel(ours, ref, rtol, name=""):
    ours = np.asarray(ours.cpu() if hasattr(ours, "cpu") else ours)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=0, err_msg=name)


@pytest.mark.parametrize("threshold", [None, 0.75], ids=["all", "sharp"])
@pytest.mark.parametrize("seed,hw", [(0, 192), (1, 160)])
def test_niqe_features_match_numpy(seed, hw, threshold):
    img = _natural_ish(seed, hw)
    ref, ref_keep = JN.niqe_features(img, 48, threshold)
    feats, keep = N.niqe_features(img, 48, threshold, device="cpu")
    assert feats.dtype.is_floating_point and feats.shape == ref.shape
    _rel(feats, ref, 1e-6, "features")
    assert (keep.numpy() == ref_keep).all()


def _write_frames(root, seeds, hw=96):
    for i, s in enumerate(seeds):
        d = os.path.join(root, f"{i // 2:03d}")
        os.makedirs(d, exist_ok=True)
        cv2.imwrite(os.path.join(d, f"{i % 2:05d}.png"),
                    _natural_ish(s, hw).astype(np.uint8))


def test_niqe_fit_and_score_match_numpy(tmp_path):
    _write_frames(str(tmp_path), range(20, 26))
    ref = JN.fit_niqe_model(str(tmp_path), block_size=32)
    model = N.fit_niqe_model(str(tmp_path), block_size=32, device="cpu")
    _rel(model["mu"], ref["mu"], 1e-6, "mu")
    np.testing.assert_allclose(model["cov"], ref["cov"], rtol=1e-6,
                               atol=1e-9 * np.abs(ref["cov"]).max())
    for seed, noise in ((30, 4.0), (31, 40.0)):
        img = _natural_ish(seed, 128, noise)
        _rel(N.niqe_score(img, model, device="cpu"),
             JN.niqe_score(img, ref), 1e-4, f"score {seed}")


def test_brisque_features_match_numpy():
    for seed, hw in ((2, 192), (3, 150)):
        img = _natural_ish(seed, hw)
        f = B.brisque_features(img, device="cpu")
        assert f.shape == (36,)
        _rel(f, JB.brisque_features(img), 1e-6, f"seed {seed}")


def _libsvm_files(tmp_path, seed=4):
    """A hand-written libsvm model and range file (3 support vectors)."""
    rng = np.random.default_rng(seed)
    sv, coef = rng.random((3, 36)), rng.normal(0, 1, 3)
    lines = ["svm_type epsilon_svr", "kernel_type rbf", "gamma 0.05",
             "nr_class 2", "total_sv 3", "rho -0.3", "SV"]
    lines += [" ".join([f"{c:.8f}"] + [f"{j + 1}:{v[j]:.8f}"
                                        for j in range(36)])
              for c, v in zip(coef, sv)]
    mp, rp = tmp_path / "allmodel", tmp_path / "allrange"
    mp.write_text("\n".join(lines) + "\n")
    rp.write_text("\n".join(["# feature range", "-1 1"] + [
        f"{j + 1} {-1.0 - j / 36} {3.0 + j}" for j in range(36)]) + "\n")
    return str(mp), str(rp)


def test_libsvm_round_trip_and_score_match_numpy(tmp_path):
    mp, rp = _libsvm_files(tmp_path)
    model, ref = B.load_libsvm_model(mp, rp), JB.load_libsvm_model(mp, rp)
    for key in ("sv", "sv_coef", "lo", "hi"):
        np.testing.assert_array_equal(model[key], ref[key])
    assert (model["gamma"], model["rho"]) == (ref["gamma"], ref["rho"])
    for seed in (5, 6):
        img = _natural_ish(seed)
        _rel(B.brisque_score(img, model, device="cpu"),
             JB.brisque_score(img, ref), 1e-4, f"seed {seed}")


def test_fit_brisque_model_matches_numpy():
    rng = np.random.default_rng(7)
    imgs, scores = [], []
    for i in range(8):
        sigma = rng.uniform(0, 60)
        imgs.append(np.clip(_natural_ish(40 + i, 96) + rng.normal(
            0, sigma, (96, 96)), 0, 255))
        scores.append(sigma)
    model = B.fit_brisque_model(imgs, scores, device="cpu")
    ref = JB.fit_brisque_model(imgs, scores)
    _rel(model["lo"], ref["lo"], 1e-6, "lo")
    _rel(model["hi"], ref["hi"], 1e-6, "hi")
    img = _natural_ish(50, 96)
    _rel(B.brisque_score(img, model, device="cpu"),
         JB.brisque_score(img, ref), 1e-4, "score")


def test_evaluate_no_reference_cli_matches_the_jax_tool(tmp_path, capsys,
                                                        monkeypatch):
    res = tmp_path / "res"
    _write_frames(str(res), range(60, 64))
    model = N.fit_niqe_model(str(res), block_size=32, device="cpu")
    npz = str(tmp_path / "niqe.npz")
    np.savez(npz, **model)
    mp, rp = _libsvm_files(tmp_path)
    argv = ["--results", str(res), "--metrics", "niqe", "brisque",
            "--niqe-model", npz, "--brisque-model", mp, "--brisque-range",
            rp]
    totals = evaluate_no_reference.main(argv + ["--device", "cpu"])
    ours = capsys.readouterr().out
    spec = importlib.util.spec_from_file_location(
        "jax_evaluate_no_reference",
        os.path.join(REPO, "tools", "evaluate_no_reference.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr("sys.argv", ["evaluate_no_reference.py"] + argv)
    tool.main()
    ref = capsys.readouterr().out
    assert ours.splitlines() == ref.splitlines()
    assert set(totals) == {"niqe", "brisque"}
