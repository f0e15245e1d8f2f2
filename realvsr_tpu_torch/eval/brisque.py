"""BRISQUE (no-reference quality): features on the device in float64, SVR
scoring, model fitting.

Counterpart of ``realvsr_tpu/eval/brisque.py``, which completes the
reference's MATLAB no-reference evaluation (``evaluate_niqe_brisque.m``):
36 NSS features (a GGD fit of the MSCN coefficients and AGGD fits of their
4 paired products, at 2 scales) mapped to a quality score by an RBF
support-vector regressor.

  * :func:`brisque_features`: the 36-dim vector, on ``device`` in float64
    (MSCN, the table argmin and the Gamma values shared with the port's
    ``eval/niqe.py``);
  * :func:`load_libsvm_model`: the original BRISQUE release's ``allmodel``
    / ``allrange`` files (libsvm eps-SVR text format);
  * :func:`fit_brisque_model`: a custom model from (image, score) pairs with
    scikit-learn's SVR and the original release's hyperparameters (imported
    in the function: the card's machine has no scikit-learn);
  * :func:`brisque_score`: an image against either model form (the kernel
    sum on the host).
"""
from __future__ import annotations

import numpy as np
import torch

from realvsr_tpu_torch.eval.niqe import (_G1, _G2, _G3, _GAM, _R_GAM,
                                         _aggd_core, _half, _image, _mscn,
                                         _table)


def _ggd_fit(vec: torch.Tensor):
    """Generalized Gaussian fit of a flat vector -> (alpha, sigma^2) by
    moment matching against the AGGD table."""
    sigma_sq = (vec * vec).mean()
    e_abs = vec.abs().mean()
    rho = sigma_sq / (e_abs ** 2).clamp_min(1e-12)
    i = torch.argmin((1.0 / _table(_R_GAM, vec) - rho) ** 2)
    return _table(_GAM, vec)[i], sigma_sq


def _aggd_fit4(vec: torch.Tensor):
    """AGGD fit of a flat vector -> (alpha, mean, left var, right var): the
    BRISQUE product parameterisation (variances, not scales)."""
    i, lsq, rsq = (t[0] for t in _aggd_core(vec[None]))
    g1, g2, g3 = (_table(t, vec)[i] for t in (_G1, _G2, _G3))
    const = torch.sqrt(g1 / g3)
    mean = (rsq - lsq) * (g2 / g1) * const
    return _table(_GAM, vec)[i], mean, lsq ** 2, rsq ** 2


def brisque_features(img, device="cuda") -> torch.Tensor:
    """The 36-dim BRISQUE feature vector of a grayscale [0, 255] image,
    float64 on ``device``."""
    cur = _image(img, device)
    feats = []
    for _ in range(2):
        struct, _ = _mscn(cur)
        feats += list(_ggd_fit(struct.reshape(-1)))
        for dy, dx in [(0, 1), (1, 0), (1, 1), (1, -1)]:
            pair = struct * torch.roll(struct, (dy, dx), dims=(0, 1))
            feats += list(_aggd_fit4(pair.reshape(-1)))
        cur = _half(cur)
    return torch.stack(feats)


# ----------------------------------------------------------------- scoring
def _scale_features(f, lo, hi):
    """libsvm-style scaling to [-1, 1] with the training min / max."""
    return -1.0 + 2.0 * (f - lo) / np.maximum(hi - lo, 1e-12)


def brisque_score(img, model: dict, device="cuda") -> float:
    """BRISQUE score (lower is better for LIVE-style training labels):
    features on ``device``, the SVR on the host."""
    fs = _scale_features(brisque_features(img, device).cpu().numpy(),
                         model["lo"], model["hi"])
    if "sklearn_svr" in model:
        return float(model["sklearn_svr"].predict(fs[None])[0])
    k = np.exp(-model["gamma"] * np.sum((model["sv"] - fs[None]) ** 2,
                                        axis=1))
    return float(model["sv_coef"] @ k - model["rho"])


def load_libsvm_model(model_path: str, range_path: str) -> dict:
    """Parse the original BRISQUE release's libsvm model and range files."""
    params, sv_coef, svs = {}, [], []
    in_sv = False
    with open(model_path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line == "SV":
                in_sv = True
                continue
            parts = line.split()
            if not in_sv:
                if parts[0] in ("gamma", "rho", "nr_class", "total_sv"):
                    params[parts[0]] = float(parts[1])
                continue
            sv_coef.append(float(parts[0]))
            vec = np.zeros(36)
            for tok in parts[1:]:
                idx, val = tok.split(":")
                vec[int(idx) - 1] = float(val)
            svs.append(vec)
    lo, hi = np.zeros(36), np.ones(36)
    with open(range_path) as fh:
        for ln in (ln.split() for ln in fh if ln.strip()):
            if len(ln) == 3 and ln[0].isdigit():
                i = int(ln[0]) - 1
                if 0 <= i < 36:
                    lo[i], hi[i] = float(ln[1]), float(ln[2])
    return {"sv": np.asarray(svs), "sv_coef": np.asarray(sv_coef),
            "gamma": params.get("gamma", 0.05),
            "rho": params.get("rho", 0.0), "lo": lo, "hi": hi}


def fit_brisque_model(images, scores, gamma_svr: float = 0.05,
                      c_svr: float = 1024.0, epsilon: float = 0.1,
                      device="cuda") -> dict:
    """Train a custom BRISQUE model from (grayscale image, score) pairs
    (the MATLAB ``fitbrisque`` workflow) with the original release's libsvm
    hyperparameters (eps-SVR, RBF, g = 0.05, C = 1024)."""
    from sklearn.svm import SVR

    feats = np.stack([brisque_features(im, device).cpu().numpy()
                      for im in images])
    lo, hi = feats.min(axis=0), feats.max(axis=0)
    svr = SVR(kernel="rbf", gamma=gamma_svr, C=c_svr, epsilon=epsilon)
    svr.fit(_scale_features(feats, lo, hi), np.asarray(scores, np.float64))
    return {"sklearn_svr": svr, "lo": lo, "hi": hi}
