"""YAML experiment-config system.

Keeps the reference's user-facing YAML schema (``codes/options/options.py``)
so reference configs run unmodified: ``model:``, ``network_G:``,
``datasets:``, ``train:``, ``path:``, ``logger:``, ``augment:`` sections,
sparse reads via a NoneDict (missing keys read as None), experiment-path
derivation, debug-mode frequency overrides, and ``check_resume`` rewiring of
pretrain paths.  GPU-id selection is replaced by the callers' explicit
``device`` argument.  A copy of ``realvsr_tpu/core/config.py``, kept here so
the PyTorch package imports nothing of the JAX one.
"""
from __future__ import annotations

import logging
import os
import os.path as osp

import yaml


class NoneDict(dict):
    """dict whose missing keys read as None (options/options.py:114-116)."""

    def __missing__(self, key):
        return None


def dict_to_nonedict(opt):
    if isinstance(opt, dict):
        return NoneDict(**{k: dict_to_nonedict(v) for k, v in opt.items()})
    if isinstance(opt, list):
        return [dict_to_nonedict(v) for v in opt]
    return opt


def dict2str(opt, indent_l: int = 1) -> str:
    msg = ""
    for k, v in opt.items():
        if isinstance(v, dict):
            msg += " " * (indent_l * 2) + k + ":[\n"
            msg += dict2str(v, indent_l + 1)
            msg += " " * (indent_l * 2) + "]\n"
        else:
            msg += " " * (indent_l * 2) + k + ": " + str(v) + "\n"
    return msg


def parse(opt_path: str, is_train: bool = True, root: str | None = None) -> NoneDict:
    """Load and normalize a YAML experiment config (options/options.py:9-68).

    Differences from the reference: no CUDA_VISIBLE_DEVICES export (the
    entry points take an explicit device); lmdb-backed roots are marked
    ``data_type: lmdb`` as in the reference.
    """
    with open(opt_path, "r") as f:
        opt = yaml.safe_load(f)

    opt["is_train"] = is_train
    scale = opt.get("scale", 1)

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        dataset["scale"] = scale
        is_lmdb = False
        for key in ("dataroot_GT", "dataroot_LQ"):
            if dataset.get(key) is not None:
                dataset[key] = osp.expanduser(dataset[key])
                if dataset[key].endswith("lmdb"):
                    is_lmdb = True
        dataset["data_type"] = "lmdb" if is_lmdb else "img"
        if str(dataset.get("mode", "")).endswith("_mc"):
            # memcached config shim (options/options.py:33-39): normalize
            # the mode so such YAMLs parse; the mc *client* is scoped out
            # (PARITY.md — no memcached in this deployment environment)
            dataset["data_type"] = "mc"
            dataset["mode"] = dataset["mode"].replace("_mc", "")

    opt.setdefault("path", {})
    for key, path in list(opt["path"].items()):
        if path and key != "strict_load":
            opt["path"][key] = osp.expanduser(path)

    if root is None:
        root = osp.abspath(osp.join(osp.dirname(__file__), osp.pardir, osp.pardir))
    opt["path"]["root"] = root

    if is_train:
        experiments_root = osp.join(root, "experiments", opt["name"])
        opt["path"]["experiments_root"] = experiments_root
        opt["path"]["models"] = osp.join(experiments_root, "models")
        opt["path"]["training_state"] = osp.join(experiments_root, "training_state")
        opt["path"]["log"] = experiments_root
        opt["path"]["val_images"] = osp.join(experiments_root, "val_images")
        if "debug" in opt["name"]:
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = osp.join(root, "results", opt["name"])
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    if "network_G" in opt:
        opt["network_G"]["scale"] = scale

    return dict_to_nonedict(opt)


def check_resume(opt, resume_iter) -> None:
    """Rewire pretrain paths when resuming (options/options.py:97-111).

    The rewritten paths point at ``<models>/<iter>_G.pth``, the port's (and
    the reference's) checkpoint names.
    """
    logger = logging.getLogger("base")
    if opt["path"]["resume_state"]:
        if opt["path"].get("pretrain_model_G") or opt["path"].get("pretrain_model_D"):
            logger.warning("pretrain_model path will be ignored when resuming training.")
        opt["path"]["pretrain_model_G"] = osp.join(
            opt["path"]["models"], f"{resume_iter}_G.pth"
        )
        if "gan" in opt["model"].lower():
            opt["path"]["pretrain_model_D"] = osp.join(
                opt["path"]["models"], f"{resume_iter}_D.pth"
            )
