"""Training orchestration (the reference's ``codes/train.py``).

Counterpart of ``realvsr_tpu/train/trainer.py`` with the same lifecycle:
config → (multi-process init) → experiment dirs and logger → datasets →
model and train state → resume → the loop (feed → train step → periodic
log / validation / checkpoint) → a final ``latest`` checkpoint; SIGTERM /
SIGINT save a resumable checkpoint before leaving the loop.
``train.mixed_precision`` computes G in bf16 with f32 parameters (a GAN's
D in f32, as in JAX).  The DCN clamp is the model's ``dcn_max_offset``,
given by the caller.

Under ``torchrun`` (``parallel/mesh.py``) each process drives one device
and takes its rows of every global batch: the world size must divide
``batch_size``; each rank's loader strides the sampler by rank; the steps
average the gradients over the ranks before each update and take the
global batch's BatchNorm and RaGAN statistics (``train/wrappers.py``,
``train/gan.py``), so every rank holds the same weights; only rank 0 logs
(the printed losses are the ranks' mean) and writes checkpoints, and the
others wait at a barrier after each save and before a resume is read;
validation round-robins the clips over the ranks and gathers their
per-folder PSNR sums and counts, so the mean of the folder means is one
process's; a stop signal on any rank stops every rank after the same step.
With ``use_tb_logger`` (and no ``debug`` in the name) rank 0 writes the
logged values as TensorBoard scalars through ``tensorboardX`` or
``torch.utils.tensorboard``, whichever imports, else warns.

A ``*GAN*`` model trains G against the discriminator of ``network_D``
(``train/gan.py``): both are saved (``<iter>_G.pth``, ``<iter>_D.pth``),
the training state holds both optimizers and schedulers, and a resume
reloads both.  A configured feature loss (``feature_criterion`` with
``feature_weight > 0``) builds the frozen VGG19 extractor, from
``path.vgg_weights`` when given, else with seeded random weights and a
warning, as the JAX trainer does.
"""
from __future__ import annotations

import logging
import math
import os
import os.path as osp
import signal
import time
from collections import defaultdict

import numpy as np
import torch

from realvsr_tpu_torch.core.config import check_resume, dict2str
from realvsr_tpu_torch.data import create_dataloader, create_dataset
from realvsr_tpu_torch.models import define_d, define_f, define_g
from realvsr_tpu_torch.ops.metrics import calculate_psnr_np
from realvsr_tpu_torch.parallel import mesh
from realvsr_tpu_torch.train import checkpoint as ckpt
from realvsr_tpu_torch.train.gan import create_gan_train_state
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.wrappers import make_eval_step, make_train_step
from realvsr_tpu_torch.utils import trace

logger = logging.getLogger("base")


def setup_logger(log_dir: str | None, name: str = "base",
                 level=logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    fmt = logging.Formatter(
        "%(asctime)s.%(msecs)03d - %(levelname)s: %(message)s",
        datefmt="%y-%m-%d %H:%M:%S")
    if not any(type(h) is logging.StreamHandler for h in lg.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        lg.addHandler(sh)
    if log_dir:  # one log file: that of the latest trainer in the process
        path = osp.abspath(osp.join(log_dir, "train.log"))
        for h in [h for h in lg.handlers
                  if isinstance(h, logging.FileHandler)]:
            lg.removeHandler(h)
            h.close()
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(path)
        fh.setFormatter(fmt)
        lg.addHandler(fh)
    return lg


class Trainer:
    """``Trainer(opt, device, dcn_max_offset).train()``; ``opt`` from
    :func:`realvsr_tpu_torch.core.config.parse` with ``is_train=True``.
    ``backend`` names the process group's backend under ``torchrun``
    (default: ``nccl`` on CUDA, ``gloo`` on the CPU)."""

    def __init__(self, opt: dict, device="cuda", *,
                 dcn_max_offset: float | None, backend: str | None = None):
        self.opt = opt
        self.device = mesh.maybe_initialize_distributed(device, backend)
        world = mesh.world_size()
        main = mesh.is_main_process()
        gbs = int(opt["datasets"]["train"]["batch_size"])
        if gbs % world:
            raise ValueError(
                f"global batch {gbs} must be divisible by {world} devices "
                f"under multi-process training (process_count={world}); "
                "raise batch_size or shrink the pool")
        if main:
            for key in ("experiments_root", "models", "training_state",
                        "val_images"):
                if opt["path"].get(key):
                    os.makedirs(opt["path"][key], exist_ok=True)
        setup_logger(opt["path"].get("log") if main else None)
        logger.disabled = not main
        logger.info(dict2str(opt))
        self.tb = None
        if opt.get("use_tb_logger") and "debug" not in opt["name"] and main:
            self.tb = _summary_writer(
                osp.join(opt["path"]["root"], "tb_logger", opt["name"]))

        self.train_loader = self.val_loader = None
        self.total_iters = int(opt["train"]["niter"])
        for phase, dataset_opt in opt["datasets"].items():
            if phase == "train":
                train_set = create_dataset(dataset_opt)
                self.train_loader = create_dataloader(train_set, dataset_opt,
                                                      opt)
                per_epoch = len(self.train_loader)
                self.total_epochs = int(math.ceil(self.total_iters
                                                  / max(1, per_epoch)))
                logger.info(
                    f"Number of train images: {len(train_set)}, iters per "
                    f"epoch: {per_epoch}; total epochs {self.total_epochs}, "
                    f"iters {self.total_iters}")
            elif phase == "val":
                val_set = create_dataset(dataset_opt)
                self.val_loader = create_dataloader(val_set, dataset_opt, opt)
                logger.info(f"Number of val images: {len(val_set)}")
        if self.train_loader is None:
            raise ValueError("the config has no datasets.train")

        seed = int(opt["train"].get("manual_seed") or 0)
        dtype = (torch.bfloat16 if opt["train"].get("mixed_precision")
                 else torch.float32)
        self.model = define_g(opt, device=self.device, dtype=dtype,
                              generator=torch.Generator().manual_seed(seed),
                              dcn_max_offset=dcn_max_offset)
        self.is_gan = "GAN" in (opt["model"] or "")
        self.model_d = None
        if self.is_gan:
            self.model_d = define_d(
                opt, device=self.device,
                generator=torch.Generator().manual_seed(seed + 1))
            self.state = create_gan_train_state(self.model, self.model_d,
                                                opt)
        else:
            self.state = create_train_state(self.model, opt)
        for label, net in (("G", self.model), ("D", self.model_d)):
            if net is not None:
                n_params = sum(p.numel() for p in net.parameters())
                logger.info(f"Network {label}: {type(net).__name__}, with "
                            f"parameters: {n_params:,d}")

        self.start_epoch, self.current_step = 0, 0
        mesh.barrier()   # a checkpoint being written is complete
        self._load_or_resume()
        # every rank starts from the same weights (the same seed draws them)
        mesh.broadcast_module(self.model)
        mesh.broadcast_module(self.model_d)
        self.train_step = make_train_step(self.model, opt,
                                          self._feature_extractor(seed))
        self.eval_step = make_eval_step(self.model)
        self.gen = torch.Generator(device=self.device).manual_seed(seed + 7)
        # (start, stop) steps of a torch.profiler trace (tools/train.py
        # --profile); None disables
        self.profile_steps = None

    def _feature_extractor(self, seed: int):
        """The frozen VGG19 of a configured feature loss, else None."""
        t = self.opt["train"]
        if not (t.get("feature_criterion")
                and float(t.get("feature_weight") or 0.0) > 0):
            return None
        net_f = define_f(self.opt, device=self.device,
                         generator=torch.Generator().manual_seed(seed))
        if self.opt["path"].get("vgg_weights"):
            from realvsr_tpu_torch.models.vgg import load_vgg19_weights

            load_vgg19_weights(net_f, self.opt["path"]["vgg_weights"])
        else:
            logger.warning("feature loss enabled without path.vgg_weights"
                           " — using randomly initialized VGG features")
        return net_f

    def _load_or_resume(self):
        opt = self.opt
        resume_path = opt["path"].get("resume_state")
        if resume_path:
            check_resume(opt, osp.basename(resume_path).split(".")[0])
            step, epoch = ckpt.load_training_state(
                resume_path, self.state.optimizers, self.state.schedulers)
            self.model.load_state_dict(
                ckpt.load_network(opt["path"]["pretrain_model_G"]),
                strict=True)
            if self.is_gan:
                self.model_d.load_state_dict(
                    ckpt.load_network(opt["path"]["pretrain_model_D"]),
                    strict=True)
            self.state.step = step
            self.start_epoch, self.current_step = epoch, step
            logger.info(f"Resuming training from epoch {epoch}, iter {step}.")
        elif opt["path"].get("pretrain_model_G"):
            strict = opt["path"].get("strict_load")
            self.model.load_state_dict(
                ckpt.load_network(opt["path"]["pretrain_model_G"]),
                strict=True if strict is None else bool(strict))
            logger.info(
                f"Loaded pretrained G from {opt['path']['pretrain_model_G']}")

    def validate(self, step: int) -> float:
        """Mean over clips of the per-frame PSNR (train.py:230-262).  The
        clips are round-robined over the ranks (frame i on rank i % W, as
        the JAX trainer does); the ranks' per-folder (sum, count) are
        gathered, so the result is one process's."""
        if self.val_loader is None:
            return float("nan")
        world, rank = mesh.world_size(), mesh.rank()
        sums = defaultdict(lambda: [0.0, 0])
        for i, batch in enumerate(self.val_loader):
            if i % world != rank:
                continue
            lqs = torch.from_numpy(batch["LQs"]).to(self.device)
            out = self.eval_step(lqs)[0].float().cpu().numpy()
            psnr = calculate_psnr_np(np.clip(out, 0, 1) * 255.0,
                                     batch["GT"][0] * 255.0)
            sums[batch["folder"][0]][0] += psnr
            sums[batch["folder"][0]][1] += 1
        folders = defaultdict(lambda: [0.0, 0])
        for part in mesh.gather_objects(dict(sums)):
            for k, (total, count) in part.items():
                folders[k][0] += total
                folders[k][1] += count
        folder_means = {k: total / count
                        for k, (total, count) in sorted(folders.items())}
        psnr_avg = float(np.mean(list(folder_means.values())))
        for k, v in folder_means.items():
            logger.info(f"Folder {k} psnr: {v:.6f}.")
        logger.info(f"# Validation # PSNR: {psnr_avg:.6f}.")
        if self.tb:
            self.tb.add_scalar("psnr_avg", psnr_avg, step)
        return psnr_avg

    def save_checkpoint(self, epoch: int, step: int | str):
        """Rank 0 writes G (and D) and the training state; every rank
        leaves once the files are complete."""
        if mesh.is_main_process():
            ckpt.save_network(self.opt["path"]["models"], "G", step,
                              self.model)
            if self.is_gan:
                ckpt.save_network(self.opt["path"]["models"], "D", step,
                                  self.model_d)
            if isinstance(step, int):
                ckpt.save_training_state(
                    self.opt["path"]["training_state"], step, epoch,
                    self.state.optimizers, self.state.schedulers)
            logger.info("Saved models and training states.")
        mesh.barrier()

    def _profile(self, prof):
        """Start (returns the profiler) or stop (returns None) the trace at
        the ``profile_steps`` window.  The window's torch.profiler trace
        goes to ``profile/trace.json``; the spans and counters of
        :mod:`~realvsr_tpu_torch.utils.trace` recorded in it, the loader
        thread's too, to ``profile/spans.json`` on the same Unix-ns
        clock."""
        if self.profile_steps is None:
            return prof
        start, stop = self.profile_steps
        if self.current_step == start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            trace.clear()
            prof.__enter__()
        elif self.current_step == stop and prof is not None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            prof.__exit__(None, None, None)
            out = osp.join(self.opt["path"]["experiments_root"], "profile")
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(osp.join(out, "trace.json"))
            trace.save(osp.join(out, "spans.json"))
            sort = ("cuda_time_total" if self.device.type == "cuda"
                    else "cpu_time_total")
            with open(osp.join(out, "summary.txt"), "w") as f:
                f.write(prof.key_averages().table(sort_by=sort,
                                                  row_limit=40))
            logger.info(f"Saved profiler trace of steps {start}-{stop} to "
                        f"{out}.")
            prof = None
        return prof

    def train(self):
        opt = self.opt
        print_freq = int(opt["logger"]["print_freq"])
        save_freq = int(opt["logger"]["save_checkpoint_freq"])
        val_freq = (int(opt["train"]["val_freq"]) if opt["train"].get("val_freq")
                    else None)

        # preemption: SIGTERM / SIGINT end the loop after the current step
        # and save a resumable checkpoint
        stop = {"flag": False}

        def _request_stop(signum, frame):
            stop["flag"] = True

        prev_handlers = {s: signal.signal(s, _request_stop)
                         for s in (signal.SIGTERM, signal.SIGINT)}
        prof = None
        try:
            logger.info(f"Start training from epoch: {self.start_epoch:d}, "
                        f"iter: {self.current_step:d}")
            t_last = time.time()
            epoch = self.start_epoch
            while self.current_step <= self.total_iters:
                for batch in self.train_loader.epoch_iter(epoch):
                    self.current_step += 1
                    if self.current_step > self.total_iters:
                        break
                    prof = self._profile(prof)
                    with trace.span("train.upload", self.current_step):
                        device_batch = {
                            k: torch.from_numpy(batch[k]).to(self.device)
                            for k in ("LQs", "GT")}
                    with trace.span("train.step", self.current_step):
                        self.state, logs = self.train_step(
                            self.state, device_batch, self.gen)

                    if self.current_step % print_freq == 0:
                        logs = _mean_logs(logs, self.device)
                        ips = print_freq / max(time.time() - t_last, 1e-9)
                        t_last = time.time()
                        msg = (f"[epoch:{epoch:3d}, iter:"
                               f"{self.current_step:8,d}, {ips:.2f} it/s] ")
                        msg += " ".join(f"{k}: {v:.4e}"
                                        for k, v in logs.items())
                        logger.info(msg)
                        if self.tb:
                            for k, v in logs.items():
                                self.tb.add_scalar(k, v, self.current_step)
                    if val_freq and self.current_step % val_freq == 0:
                        self.validate(self.current_step)
                    if self.current_step % save_freq == 0:
                        self.save_checkpoint(epoch, self.current_step)
                    stop["flag"] = mesh.any_rank(stop["flag"])
                    if stop["flag"]:
                        break
                if stop["flag"]:
                    logger.info("Stop signal received — saving and exiting.")
                    self.save_checkpoint(epoch, self.current_step)
                    break
                epoch += 1
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
            for s, h in prev_handlers.items():
                signal.signal(s, h)
        self.save_checkpoint(epoch, "latest")
        if self.tb:
            self.tb.close()
        logger.info("End of training.")
        return self.state


def _mean_logs(logs: dict, device) -> dict:
    """The logged values as floats, each the mean over the ranks (the
    global batch's loss, as JAX logs it)."""
    vals = torch.stack([torch.as_tensor(v, dtype=torch.float32).to(device)
                        for v in logs.values()])
    return dict(zip(logs, mesh.all_reduce_mean(vals).tolist()))


def _summary_writer(log_dir: str):
    """A TensorBoard ``SummaryWriter`` from tensorboardX or
    ``torch.utils.tensorboard``, or None with a warning when neither
    imports."""
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            logger.warning("neither tensorboardX nor tensorboard imports; "
                           "TB logging disabled")
            return None
    return SummaryWriter(log_dir=log_dir)
