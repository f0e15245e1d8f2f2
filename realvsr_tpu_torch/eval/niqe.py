"""NIQE (no-reference quality): fitting and scoring, the feature pass on the
device in float64.

Counterpart of ``realvsr_tpu/eval/niqe.py`` (numpy / scipy), which rebuilds
the reference's MATLAB workflow (``fit_niqe_model.m``: a custom NIQE model
fitted on RealVSR GT frames, 96 x 96 blocks, and result sequences scored
against it):

  * MSCN coefficients: a 7 x 7 Gaussian (sigma 7/6) correlation with
    replicate padding (scipy's ``mode="nearest"``), as one ``conv2d``;
  * blocks taken with ``unfold``; the AGGD moment-matching fits of MSCN and
    its 4 paired products vectorised over blocks, with the ``_R_GAM``
    table's argmin; the paired products through ``torch.roll`` inside each
    block, as ``np.roll`` does;
  * 18 features x 2 scales (the second a 2 x 2 average pool) = 36 per
    block;
  * fit: sharpness-selected blocks -> a multivariate Gaussian (mu, cov);
  * score: the distance between the model's MVG and the image's (a
    ``pinv`` of a 36 x 36 matrix, on the host in numpy).

Everything runs in float64 so that it agrees with the numpy reference.  The
alpha tables and the Gamma values at them are the reference's own (scipy),
indexed by the argmin.  BRISQUE (``eval/brisque.py``) shares :func:`_mscn`,
:func:`_aggd_core` and the tables.
"""
from __future__ import annotations

import glob
import os.path as osp

import numpy as np
import torch
import torch.nn.functional as F
from scipy.special import gamma

from realvsr_tpu_torch.data.imageio import read_gray


def _gaussian_window(size: int = 7, sigma: float = 7.0 / 6.0) -> np.ndarray:
    ax = np.arange(size) - size // 2
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    w = np.outer(g, g)
    return w / w.sum()


_WIN = _gaussian_window()

# AGGD alpha lookup table, and the Gamma values the fits take at each alpha
_GAM = np.arange(0.2, 10.001, 0.001)
_R_GAM = (gamma(2.0 / _GAM) ** 2) / (gamma(1.0 / _GAM) * gamma(3.0 / _GAM))
_G1, _G2, _G3 = gamma(1.0 / _GAM), gamma(2.0 / _GAM), gamma(3.0 / _GAM)


def _table(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float64, device=like.device)


def _image(img, device) -> torch.Tensor:
    """A grayscale [0, 255] image (array or tensor) as float64 on
    ``device``."""
    if not torch.is_tensor(img):
        img = torch.from_numpy(np.ascontiguousarray(img))
    return img.to(device, torch.float64)


def _mscn(img: torch.Tensor):
    """MSCN coefficients and the local sigma field of (..., H, W) images."""
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    win = _table(_WIN, x)[None, None]
    pad = _WIN.shape[0] // 2

    def corr(t):
        return F.conv2d(F.pad(t, (pad,) * 4, mode="replicate"), win)

    mu = corr(x)
    sigma = torch.sqrt(torch.abs(corr(x * x) - mu ** 2))
    struct = (x - mu) / (sigma + 1.0)
    return struct.reshape(*lead, *img.shape[-2:]), \
        sigma.reshape(*lead, *img.shape[-2:])


def _aggd_core(vec: torch.Tensor):
    """AGGD moment matching of each row of ``vec`` (N, M): (table index of
    alpha, left scale, right scale), each (N,)."""
    neg, pos = vec < 0, vec > 0
    sq = vec * vec
    n_l, n_r = neg.sum(1), pos.sum(1)
    lsq = torch.where(n_l > 0, torch.sqrt(
        (sq * neg).sum(1) / n_l.clamp_min(1)), vec.new_tensor(1e-6))
    rsq = torch.where(n_r > 0, torch.sqrt(
        (sq * pos).sum(1) / n_r.clamp_min(1)), vec.new_tensor(1e-6))
    gammahat = lsq / rsq.clamp_min(1e-6)
    rhat = vec.abs().mean(1) ** 2 / sq.mean(1).clamp_min(1e-12)
    rhatnorm = (rhat * (gammahat ** 3 + 1) * (gammahat + 1)) / \
        ((gammahat ** 2 + 1) ** 2)
    pos_idx = torch.argmin((_table(_R_GAM, vec)[None, :]
                            - rhatnorm[:, None]) ** 2, dim=1)
    return pos_idx, lsq, rsq


def _aggd_fit(vec: torch.Tensor):
    """Asymmetric generalized Gaussian fit of each row -> (alpha, beta_l,
    beta_r)."""
    i, lsq, rsq = _aggd_core(vec)
    c = torch.sqrt(_table(_G1, vec)[i] / _table(_G3, vec)[i])
    return _table(_GAM, vec)[i], lsq * c, rsq * c


def _block_features(struct: torch.Tensor) -> torch.Tensor:
    """The 18 NSS features of each MSCN block (N, bs, bs) -> (N, 18)."""
    n = struct.shape[0]
    alpha, bl, br = _aggd_fit(struct.reshape(n, -1))
    feats = [alpha, (bl + br) / 2.0]
    for dy, dx in [(0, 1), (1, 0), (1, 1), (1, -1)]:  # H, V, D1, D2
        pair = struct * torch.roll(struct, (dy, dx), dims=(1, 2))
        i, lsq, rsq = _aggd_core(pair.reshape(n, -1))
        g1, g2, g3 = (_table(t, struct)[i] for t in (_G1, _G2, _G3))
        c = torch.sqrt(g1 / g3)
        bl, br = lsq * c, rsq * c
        const = torch.sqrt(g1) / torch.sqrt(g3)
        mean = (br - bl) * (g2 / g1) * const
        feats += [_table(_GAM, struct)[i], mean, bl, br]
    return torch.stack(feats, dim=1)


def _blocks(t: torch.Tensor, bs: int) -> torch.Tensor:
    """The bs x bs blocks of an (H, W) field, row by row: (N, bs, bs)."""
    return t.unfold(0, bs, bs).unfold(1, bs, bs).reshape(-1, bs, bs)


def _half(t: torch.Tensor) -> torch.Tensor:
    """The 2 x 2 average pool (even crop) of an (H, W) image."""
    hh, ww = t.shape[0] // 2 * 2, t.shape[1] // 2 * 2
    c = t[:hh, :ww]
    return (c[0::2, 0::2] + c[1::2, 0::2] + c[0::2, 1::2] + c[1::2, 1::2]) \
        / 4.0


def niqe_features(img, block_size: int = 96,
                  sharpness_threshold: float | None = None, device="cuda"):
    """Per-block 36-dim features of a grayscale [0, 255] image, in float64
    on ``device``.

    Returns (features (N, 36), used-block mask (N,)): with a sharpness
    threshold, only blocks whose mean local sigma exceeds threshold * max
    are kept (the fitniqe selection rule), where at least two are.
    """
    img = _image(img, device)
    h, w = img.shape
    nbh, nbw = h // block_size, w // block_size
    cur = img[:nbh * block_size, :nbw * block_size]
    feats_scales, sharpness = [], None
    for scale in range(2):
        struct, sigma = _mscn(cur)
        bs = block_size >> scale
        feats_scales.append(_block_features(_blocks(struct, bs)))
        if scale == 0:
            sharpness = _blocks(sigma, bs).mean((1, 2))
        cur = _half(cur)
    feats = torch.cat(feats_scales, dim=1)
    if sharpness_threshold is not None and sharpness.numel():
        keep = sharpness > sharpness_threshold * sharpness.max()
        if int(keep.sum()) >= 2:
            return feats[keep], keep
    return feats, torch.ones(len(feats), dtype=torch.bool, device=img.device)


def fit_niqe_model(gt_root: str, block_size: int = 96,
                   sharpness_threshold: float = 0.75,
                   max_images: int | None = None, device="cuda") -> dict:
    """Fit a custom NIQE model on a tree of GT frames (fit_niqe_model.m):
    PNGs under ``<root>/*/*.png`` (else ``<root>/*.png``), read as
    grayscale.  Returns {"mu": (36,), "cov": (36, 36), "block_size"}, numpy
    float64 (save with np.savez)."""
    paths = sorted(glob.glob(osp.join(gt_root, "*", "*.png"))) or \
        sorted(glob.glob(osp.join(gt_root, "*.png")))
    if max_images:
        paths = paths[:max_images]
    if not paths:
        raise FileNotFoundError(f"no PNGs under {gt_root}")
    feats = torch.cat([niqe_features(read_gray(p), block_size,
                                     sharpness_threshold, device)[0]
                       for p in paths]).cpu().numpy()
    return {"mu": feats.mean(axis=0), "cov": np.cov(feats, rowvar=False),
            "block_size": np.asarray(block_size)}


def load_matlab_niqe_model(path: str) -> dict:
    """Load a MATLAB-fitted niqeModel from a .mat file (e.g. the
    reference's ``metrics/models/niqe_model_realvsr_all.mat``).

    MATLAB saves fitniqe results as an opaque MCOS object that scipy cannot
    decode; its numeric payload lives in the embedded
    ``__function_workspace__`` MAT5 stream, scanned here for the miDOUBLE
    elements of the niqeModel's shapes: mean (36,), covariance (36, 36),
    block size (2,), sharpness threshold (1,).
    """
    import struct

    import scipy.io as sio

    m = sio.loadmat(path)
    fw = m.get("__function_workspace__")
    if fw is None:
        raise ValueError(f"{path}: no MCOS function workspace found")
    data = fw.tobytes()
    mu = cov = block = thr = None
    for off in range(0, len(data) - 8, 4):
        t, nb = struct.unpack_from("<ii", data, off)
        if t != 9:  # miDOUBLE
            continue
        cnt = nb // 8
        if cnt not in (36, 36 * 36, 2, 1):
            continue
        arr = np.frombuffer(data, np.float64, count=cnt, offset=off + 8)
        if not np.all(np.isfinite(arr)):
            continue
        if cnt == 36 and mu is None:
            mu = arr.copy()
        elif cnt == 36 * 36 and cov is None:
            cov = arr.copy().reshape(36, 36)
        elif cnt == 2 and block is None and np.all(arr > 0) and \
                np.all(arr == np.round(arr)):
            block = arr.copy()
        elif cnt == 1 and thr is None and 0 <= arr[0] <= 1:
            thr = float(arr[0])
    if mu is None or cov is None:
        raise ValueError(f"{path}: could not locate niqeModel arrays")
    return {"mu": mu, "cov": cov,
            "block_size": np.asarray(int(block[0]) if block is not None
                                     else 96),
            "sharpness_threshold": np.asarray(0.0 if thr is None else thr)}


def niqe_score(img, model: dict, block_size: int | None = None,
               device="cuda") -> float:
    """NIQE score of a grayscale [0, 255] image against a fitted model
    (lower is better): features on ``device``, the MVG distance on the
    host."""
    bs = int(model.get("block_size", 96)) if block_size is None else \
        block_size
    feats = niqe_features(img, bs, None, device)[0].cpu().numpy()
    d = model["mu"] - feats.mean(axis=0)
    cov_avg = (model["cov"] + np.cov(feats, rowvar=False)) / 2.0
    inv = np.linalg.pinv(cov_avg)
    return float(np.sqrt(max(d @ inv @ d, 0.0)))
