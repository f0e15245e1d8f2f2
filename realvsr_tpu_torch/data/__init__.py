"""Dataset / dataloader factories (the reference's ``codes/data/__init__.py``),
counterparts of ``realvsr_tpu/data/__init__.py``: every mode of the JAX
factory (RealVSR, Vimeo90K, their AllPair forms, VideoTest and the
synthetic fixtures)."""
from __future__ import annotations


def create_dataset(dataset_opt: dict):
    mode = dataset_opt["mode"]
    if mode == "RealVSR":
        from realvsr_tpu_torch.data.realvsr import RealVSRDataset as D
    elif mode == "RealVSR_AllPair":
        from realvsr_tpu_torch.data.realvsr import RealVSRAllPairDataset as D
    elif mode == "Vimeo90K":
        from realvsr_tpu_torch.data.vimeo90k import Vimeo90KDataset as D
    elif mode == "Vimeo90K_AllPair":
        from realvsr_tpu_torch.data.vimeo90k import (
            Vimeo90KAllPairDataset as D)
    elif mode == "VideoTest":
        from realvsr_tpu_torch.data.video_test import VideoTestDataset as D
    elif mode == "Synthetic":
        from realvsr_tpu_torch.data.synthetic import SyntheticVSRDataset as D
    elif mode == "SyntheticTest":
        from realvsr_tpu_torch.data.synthetic import (
            SyntheticVideoTestDataset as D)
    elif mode == "SyntheticMotion":
        from realvsr_tpu_torch.data.synthetic import (
            SyntheticMotionVSRDataset as D)
    elif mode == "SyntheticMotionTest":
        from realvsr_tpu_torch.data.synthetic import (
            SyntheticMotionVideoTestDataset as D)
    else:
        raise NotImplementedError(f"Dataset [{mode}] is not recognized.")
    return D(dataset_opt)


def create_dataloader(dataset, dataset_opt: dict, opt: dict | None = None):
    """A :class:`TrainLoader` for the train phase (this rank's share of the
    global batch under a process group), else an :class:`EvalLoader`."""
    from realvsr_tpu_torch.data.loader import EvalLoader, TrainLoader
    from realvsr_tpu_torch.parallel.mesh import rank, world_size

    if dataset_opt["phase"] == "train":
        return TrainLoader(
            dataset,
            batch_size=dataset_opt["batch_size"],
            num_replicas=world_size(),
            rank=rank(),
            ratio=int(dataset_opt.get("dataset_ratio") or 200),
            num_workers=int(dataset_opt.get("n_workers") or 3),
            seed=int(((opt or {}).get("train") or {}).get("manual_seed") or 0),
        )
    return EvalLoader(dataset)
