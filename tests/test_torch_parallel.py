"""The port's multi-process training on the CPU: two ``gloo`` processes,
started with torchrun's environment on a free port as
``tests/test_multiprocess.py`` starts its two (``tests/
torch_parallel_worker.py`` is one rank).

  * A Split step of EDVRNoUp (nf 16, 1 + 1 ResBlocks, 48x48, global batch
    4): the two ranks' parameters are bit-identical, their averaged
    gradients equal the one-process port step's on the global batch within
    1e-5 of each tensor's largest, and JAX's global-batch gradients within
    the 1e-4 of ``test_torch_train.py``.
  * A GAN-Split step with ``ragan`` and D's BatchNorms (the nf 16 debug
    GAN config): the gradients of G and D and D's running statistics
    against the one-process step within 1e-5 of their largest (a bias that
    feeds a BN, whose gradient is rounding, and D's output bias, whose
    gradient nearly cancels, against their model's largest) plus twice
    the one-process step's own change when the global batch is reordered
    (rounding alone moves D's gradients through its BatchNorms' backward
    by up to 3.7e-5 of their largest at this seed),
    the parameters within 2 LR (Adam's first update is LR * g / (|g| +
    eps)).
  * ``Trainer`` on two ranks (the nf 16 debug Split config): each rank's
    loader indices equal JAX's ``IterationSampler(num_replicas=2,
    rank=r)``; the validation PSNR equals one process's; only rank 0 writes
    checkpoints; a resume on two ranks carries on to the end; a SIGTERM to
    one rank stops both after the same step.
"""
import json
import os
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from realvsr_tpu.data.loader import IterationSampler as JaxSampler
from realvsr_tpu.losses import get_pixel_criterion as jax_criterion
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models import define_d, define_g
from realvsr_tpu_torch.train.gan import create_gan_train_state
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.wrappers import make_train_step
from torch_jax_params import random_variables, smooth_batch
from torch_parallel_worker import launch, wait

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "configs", "train")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(tmp_path, task, args, world=2):
    wait(launch(tmp_path, task, args, world))


def _yaml(name):
    with open(os.path.join(CFG, name)) as f:
        return yaml.safe_load(f)


def _one_process_step(opt, init, batch, max_offset=None):
    g = define_g(opt, device="cpu", dcn_max_offset=max_offset)
    g.load_state_dict(init["G"])
    d = None
    if "D" in init:
        d = define_d(opt, device="cpu")
        d.load_state_dict(init["D"])
    state = (create_gan_train_state(g, d, opt) if d is not None
             else create_train_state(g, opt))
    make_train_step(g, opt)(state, {k: torch.from_numpy(v)
                                    for k, v in batch.items()},
                            torch.Generator())
    out = {"grads": {}, "params": {}, "stats": {}}
    for n, net in (("G", g), ("D", d)):
        if net is None:
            continue
        for k, p in net.named_parameters():
            out["grads"][f"{n}.{k}"] = p.grad
            out["params"][f"{n}.{k}"] = p.detach()
        for k, b in net.named_buffers():
            if "running" in k:
                out["stats"][f"{n}.{k}"] = b
    return out


def _bn_fed(key, keys):
    """A conv bias whose output feeds a BatchNorm (its gradient is
    rounding): the discriminators' ``convN.bias`` beside a ``bnN``; and
    D's ``conv_out.bias``, whose gradient is the sum of the real and fake
    logits' opposite-signed terms, which nearly cancel (3e-4 against terms
    of ~0.5 / N at this seed)."""
    if key.endswith("conv_out.bias"):
        return True
    if not key.endswith(".bias") or ".conv" not in key:
        return False
    head, _, name = key[:-len(".bias")].rpartition(".")
    return f"{head}.bn{name[len('conv'):]}.running_mean" in keys or any(
        k.startswith(f"{head}.bn{name[len('conv'):]}.") for k in keys)


def _hold(got, ref, rel, keys_all=(), spread=None):
    """Each tensor within ``rel`` of its largest magnitude (a BN-fed bias
    within ``rel`` of its model's largest), plus twice its ``spread``."""
    top = {m: max(v.abs().max().item() for k, v in ref.items()
                  if k.startswith(m)) for m in ("G.", "D.")
           if any(k.startswith(m) for k in ref)}
    worst = (0.0, None)
    for k, v in ref.items():
        scale = (top[k[:2]] if _bn_fed(k, keys_all)
                 else max(v.abs().max().item(), 1e-30))
        bound = rel * scale + (2 * spread[k] if spread else 0.0)
        err = (got[k] - v).abs().max().item() / bound
        worst = max(worst, (err, k))
    assert worst[0] <= 1.0, worst
    return worst


def _split_opt():
    opt = _yaml("train_EDVR_woTSA_RealVSR_YCbCr_Split.yml")
    opt["augment"] = None
    opt["network_G"].update(nf=16, groups=4, front_RBs=1, back_RBs=1)
    return opt


def test_split_step_two_ranks_matches_one_process_and_jax(tmp_path):
    opt = _split_opt()
    rng = np.random.default_rng(0)
    batch = smooth_batch(48, seed=1, batch=4)
    jmodel = JaxEDVRNoUp(nf=16, nc=3, nframes=3, groups=4, front_RBs=1,
                         back_RBs=1, w_TSA=False)
    params = random_variables(jmodel, rng, jnp.zeros((1, 3, 48, 48, 3)))[
        "params"]
    init = {"G": state_dict_from_jax(params)}
    torch.save(init, tmp_path / "init.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    procs = launch(tmp_path, "step", dict(
        opt=opt, init=str(tmp_path / "init.pt"),
        batch=str(tmp_path / "batch.npz"), out=str(tmp_path / "step")))

    # JAX's gradient of the global batch's loss, while the ranks run
    t = opt["train"]
    cri_y = jax_criterion(t["pixel_criterion_y"])
    cri_c = jax_criterion(t["pixel_criterion_c"])
    gt_c = jnp.asarray(batch["GT"][:, 1])

    def loss_fn(p):
        pred = jmodel.apply({"params": p}, jnp.asarray(batch["LQs"]))
        return (cri_y(pred[..., 0:1], gt_c[..., 0:1])
                + cri_c(pred[..., 1:3], gt_c[..., 1:3]))

    jgrads = state_dict_from_jax(jax.device_get(
        jax.jit(jax.grad(loss_fn))(params)))
    one = _one_process_step(opt, init, batch)
    wait(procs)

    ranks = [torch.load(tmp_path / f"step.{r}.pt") for r in range(2)]
    for k, v in ranks[0]["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k
    _hold(ranks[0]["grads"], one["grads"], 1e-5)
    _hold(ranks[0]["grads"], {f"G.{k}": torch.from_numpy(np.asarray(v))
                              for k, v in jgrads.items()}, 1e-4)
    lr = float(t["lr_G"])
    for k, v in one["params"].items():
        assert (ranks[0]["params"][k] - v).abs().max().item() <= 2 * lr, k


def test_gan_step_two_ranks_matches_one_process(tmp_path):
    """RaGAN's batch means and D's BatchNorm statistics are global: the
    two ranks' step is the one-process step of the global batch."""
    opt = _yaml("debug_EDVR-GAN_Split_synthetic.yml")
    opt["augment"] = None
    assert opt["train"]["gan_type"] == "ragan"
    g = define_g(opt, device="cpu", dcn_max_offset=8.0,
                 generator=torch.Generator().manual_seed(0))
    d = define_d(opt, device="cpu",
                 generator=torch.Generator().manual_seed(1))
    assert any("bn" in k for k in d.state_dict())
    init = {"G": g.state_dict(), "D": d.state_dict()}
    torch.save(init, tmp_path / "init.pt")
    batch = smooth_batch(48, seed=3, batch=4)
    np.savez(tmp_path / "batch.npz", **batch)
    procs = launch(tmp_path, "step", dict(
        opt=opt, init=str(tmp_path / "init.pt"), max_offset=8.0,
        batch=str(tmp_path / "batch.npz"), out=str(tmp_path / "gan")))
    one = _one_process_step(opt, init, batch, max_offset=8.0)
    # rounding alone: the same global batch in another order
    perm = _one_process_step(opt, init, {k: v[[2, 3, 0, 1]]
                                         for k, v in batch.items()},
                             max_offset=8.0)
    spread = {k: (perm[p][k] - v).abs().max().item()
              for p in ("grads", "stats") for k, v in one[p].items()}
    # the same step on the first half alone differs: the coupling matters
    half = _one_process_step(opt, init, {k: v[:2] for k, v in batch.items()},
                             max_offset=8.0)
    wait(procs)
    ranks = [torch.load(tmp_path / f"gan.{r}.pt") for r in range(2)]
    for part in ("params", "stats"):
        for k, v in ranks[0][part].items():
            assert torch.equal(v, ranks[1][part][k]), k
    keys = list(one["grads"]) + list(one["stats"])
    _hold(ranks[0]["grads"], one["grads"], 1e-5, keys, spread)
    _hold(ranks[0]["stats"], one["stats"], 1e-5, (), spread)
    assert max((half["grads"][k] - v).abs().max().item()
               / max(v.abs().max().item(), 1e-30)
               for k, v in one["grads"].items() if k.startswith("D.")) > 1e-2
    assert max((half["stats"][k] - v).abs().max().item()
               for k, v in one["stats"].items()) > 1e-3
    lr = float(opt["train"]["lr_G"])
    for k, v in one["params"].items():
        assert (ranks[0]["params"][k] - v).abs().max().item() <= 2 * lr, k


def _debug_yaml(tmp_path, niter=12, **path):
    opt = _yaml("debug_EDVR_woTSA_Split_synthetic.yml")
    opt["train"].update(niter=niter, T_period=[niter, niter],
                        restarts=[niter])
    opt["datasets"]["train"]["GT_size"] = 32   # the CPU's DCN is slow
    opt["datasets"]["val"].update(num_seqs=2, frames_per_seq=3)
    opt["path"].update(path)
    out = tmp_path / f"debug_{niter}_{len(path)}.yml"
    out.write_text(yaml.safe_dump(opt))
    return str(out)


def test_trainer_two_ranks_validates_checkpoints_and_resumes(tmp_path):
    root = tmp_path / "root"
    procs = launch(tmp_path, "train", dict(
        opt=_debug_yaml(tmp_path), root=str(root), validate_first=True,
        out=str(tmp_path / "train")))

    # one process from the same seed: the same weights at step 0
    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train.trainer import Trainer

    solo = Trainer(parse(_debug_yaml(tmp_path), is_train=True,
                         root=str(tmp_path / "solo")),
                   device="cpu", dcn_max_offset=8.0)
    psnr_one = solo.validate(0)
    del solo
    wait(procs)
    res = [json.loads((tmp_path / f"train.{r}.json").read_text())
           for r in range(2)]
    ds = _yaml("debug_EDVR_woTSA_Split_synthetic.yml")["datasets"]["train"]
    n = ds["num_seqs"] * ds["frames_per_seq"]
    for r, got in enumerate(res):
        # the loop leaves at niter + 1, as the JAX trainer's does
        assert got["world"] == 2 and got["step"] == 13
        assert got["per_rank_batch"] == ds["batch_size"] // 2
        jax_idx = JaxSampler(n, num_replicas=2, rank=r,
                             ratio=ds["dataset_ratio"]).indices(0)[:64]
        assert got["indices"] == jax_idx.tolist()
        assert got["psnr0"] == pytest.approx(psnr_one, abs=1e-6)
    assert res[1]["saves"] == [] and len(res[0]["saves"]) == 3
    models = root / "experiments" / "debug_EDVR_woTSA_Split_synthetic"
    assert sorted(os.listdir(models / "models")) == [
        "8_G.pth", "latest_G.pth"]

    # resume both ranks from step 8 and carry on to 12
    state = models / "training_state" / "8.state"
    (models / "train.log").unlink()
    run(tmp_path, "train", dict(
        opt=_debug_yaml(tmp_path, resume_state=str(state)),
        root=str(root), out=str(tmp_path / "resume")))
    res = [json.loads((tmp_path / f"resume.{r}.json").read_text())
           for r in range(2)]
    assert [r["step"] for r in res] == [13, 13]
    log = (models / "train.log").read_text()
    assert "Resuming training from epoch" in log
    assert "iter:       9" in log and "iter:      12" in log


def test_sigterm_on_one_rank_stops_both(tmp_path):
    progress = tmp_path / "progress"
    procs = launch(tmp_path, "train", dict(
        opt=_debug_yaml(tmp_path, niter=400), root=str(tmp_path / "root"),
        progress=str(progress), out=str(tmp_path / "stop")))
    deadline = time.time() + 180
    while time.time() < deadline:
        try:
            if int((tmp_path / "progress.1").read_text() or 0) >= 3:
                break
        except (FileNotFoundError, ValueError):
            pass
        assert all(p.poll() is None for p in procs)
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)
    wait(procs, timeout=120)
    res = [json.loads((tmp_path / f"stop.{r}.json").read_text())
           for r in range(2)]
    assert res[0]["step"] == res[1]["step"] < 400
    step = res[0]["step"]
    models = (tmp_path / "root" / "experiments"
              / "debug_EDVR_woTSA_Split_synthetic")
    assert f"{step}.state" in os.listdir(models / "training_state")
