"""Dataset / dataloader factories (the reference's ``codes/data/__init__.py``),
counterparts of ``realvsr_tpu/data/__init__.py``.  Ported so far: the
recipe's validation mode (``VideoTest``) and the ``Synthetic`` modes; the
RealVSR, Vimeo90K and motion-synthetic modes raise (ROADMAP)."""
from __future__ import annotations

_NOT_PORTED = ("RealVSR", "RealVSR_AllPair", "Vimeo90K", "Vimeo90K_AllPair",
               "SyntheticMotion", "SyntheticMotionTest")


def create_dataset(dataset_opt: dict):
    mode = dataset_opt["mode"]
    if mode == "VideoTest":
        from realvsr_tpu_torch.data.video_test import VideoTestDataset as D
    elif mode == "Synthetic":
        from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset as D
    elif mode == "SyntheticTest":
        from realvsr_tpu_torch.data.synthetic import (
            SyntheticVideoTestDataset as D)
    elif mode in _NOT_PORTED:
        raise NotImplementedError(
            f"Dataset [{mode}] is not ported yet (ROADMAP, queue 1, "
            "\"Still to port\": the RealVSR / Vimeo90K datasets)")
    else:
        raise NotImplementedError(f"Dataset [{mode}] is not recognized.")
    return D(dataset_opt)


def create_dataloader(dataset, dataset_opt: dict, opt: dict | None = None):
    """A :class:`TrainLoader` for the train phase (one process), else an
    :class:`EvalLoader`."""
    from realvsr_tpu_torch.data.loader import EvalLoader, TrainLoader

    if dataset_opt["phase"] == "train":
        return TrainLoader(
            dataset,
            batch_size=dataset_opt["batch_size"],
            ratio=int(dataset_opt.get("dataset_ratio") or 200),
            num_workers=int(dataset_opt.get("n_workers") or 3),
            seed=int(((opt or {}).get("train") or {}).get("manual_seed") or 0),
        )
    return EvalLoader(dataset)
