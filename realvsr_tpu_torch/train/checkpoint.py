"""Checkpoints in the reference's two-file scheme
(``codes/models/base_model.py:77-141``): network weights as
``<models>/<iter>_G.pth`` (and a GAN's ``_D.pth``) state dicts under the
reference key names, BatchNorm buffers included, and the trainer state
(step, epoch, the optimizers and schedulers: G's, then D's) as
``<training_state>/<iter>.state``.  The JAX package's Orbax directories are
read through ``tools/orbax_to_pth.py`` (ROADMAP, queue 1, item 6), which
runs where JAX is installed and writes a ``.pth`` that loads here.
"""
from __future__ import annotations

import os
import os.path as osp

import torch


def save_network(models_dir: str, label: str, step, model) -> str:
    """Save ``model``'s state dict (on the CPU) as
    ``<models_dir>/<step>_<label>.pth``; returns the path."""
    os.makedirs(models_dir, exist_ok=True)
    path = osp.join(models_dir, f"{step}_{label}.pth")
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return path


def load_network(path: str) -> dict[str, torch.Tensor]:
    """A torch ``.pth`` state dict, ``module.`` prefixes stripped
    (base_model.py:90-95)."""
    if osp.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, an Orbax checkpoint of the JAX package: "
            "convert it first with `python tools/orbax_to_pth.py -opt "
            f"<config.yml> --ckpt {path} --out <file.pth>` where JAX is "
            "installed (ROADMAP, queue 1, item 6)")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def load_network_separately(path_a: str, path_b: str, name_a: str,
                            name_b: str) -> dict[str, torch.Tensor]:
    """Two-checkpoint merge (base_model.py:99-119,
    ``realvsr_tpu/train/checkpoint.py::load_network_separately``): the
    entries whose top-level module name contains ``name_a`` from checkpoint
    A, those whose name contains ``name_b`` from B, every other one from
    A."""
    sd_a, sd_b = load_network(path_a), load_network(path_b)
    merged = {}
    for key, value in sd_a.items():
        top = key.split(".")[0]
        merged[key] = (sd_b[key] if name_a not in top and name_b in top
                       else value)
    return merged


def save_training_state(state_dir: str, step: int, epoch: int, optimizers,
                        schedulers) -> str:
    """Trainer-state checkpoint (base_model.py:121-130) of the lists
    ``optimizers`` and ``schedulers``; returns the path."""
    os.makedirs(state_dir, exist_ok=True)
    path = osp.join(state_dir, f"{step}.state")
    torch.save({"step": step, "epoch": epoch,
                "optimizers": [o.state_dict() for o in optimizers],
                "schedulers": [s.state_dict() for s in schedulers]}, path)
    return path


def load_training_state(path: str, optimizers, schedulers
                        ) -> tuple[int, int]:
    """Restore ``optimizers`` and ``schedulers`` (lists, in the order they
    were saved) in place; returns (step, epoch)."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if len(state["optimizers"]) != len(optimizers):
        raise ValueError(f"{path} holds {len(state['optimizers'])} "
                         f"optimizers, the model {len(optimizers)}")
    for o, sd in zip(optimizers, state["optimizers"]):
        o.load_state_dict(sd)
    for s, sd in zip(schedulers, state["schedulers"]):
        s.load_state_dict(sd)
    return int(state["step"]), int(state["epoch"])
