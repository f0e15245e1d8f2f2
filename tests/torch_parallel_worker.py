"""One rank of the port's multi-process tests (``test_torch_parallel.py``,
``test_torch_spatial.py``, ``test_torch_cuda.py``), started by
:func:`launch` with torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):

    python tests/torch_parallel_worker.py <task> <args.json>

It imports no JAX, so the card's tests use it too.

Tasks (each writes ``<out>.<rank>.pt`` or ``.json``):

  * ``step``: one train step (Split or GAN-Split) of the models in
    ``init`` on this rank's rows of the global batch in ``batch``, on
    ``device`` (the CPU by default) over ``backend`` (gloo by default);
    saves the gradients, the parameters and the BN running statistics
    after it;
  * ``train``: a ``Trainer`` on ``device`` (the CPU by default) over
    ``backend`` (the Trainer's default) from the YAML ``opt``; records the
    train loader's indices of epoch 0, the validation PSNR before training,
    which checkpoint writers ran on this rank and the last step, and with
    ``progress`` writes each step number to ``<progress>.<rank>`` (the
    stop-signal test waits on it);
  * ``spatial``: ``eval/spatial.py::spatial_sharded_forward`` of the model
    in ``init`` over the window in ``batch``, on ``device`` (the CPU by
    default) over ``backend``; writes the kernels' launches of the call
    beside it.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from realvsr_tpu_torch.parallel import mesh  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(tmp_path, task, args, world=2):
    """Start ``world`` ranks of ``task`` (torchrun's environment on a free
    port, one torch thread each); returns the processes."""
    path = tmp_path / f"{task}_args.json"
    path.write_text(json.dumps(args))
    port = _free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, str(path)],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    return procs


def wait(procs, timeout=240):
    """Wait for the ranks; raise with its output if one failed."""
    try:
        logs = [p.communicate(timeout=timeout)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-4000:]}"
    return logs


def _models(args, device="cpu"):
    from realvsr_tpu_torch.models import define_d, define_g

    opt = args["opt"]
    g = define_g(opt, device=device, dcn_max_offset=args.get("max_offset"))
    init = torch.load(args["init"], weights_only=True)
    g.load_state_dict(init["G"])
    d = None
    if "D" in init:
        d = define_d(opt, device=device)
        d.load_state_dict(init["D"])
    return opt, g, d


def step(args):
    from realvsr_tpu_torch.train.gan import create_gan_train_state
    from realvsr_tpu_torch.train.state import create_train_state
    from realvsr_tpu_torch.train.wrappers import make_train_step

    device = mesh.maybe_initialize_distributed(args.get("device", "cpu"),
                                               args.get("backend", "gloo"))
    opt, g, d = _models(args, device)
    state = (create_gan_train_state(g, d, opt) if d is not None
             else create_train_state(g, opt))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in np.load(args["batch"]).items()}
    make_train_step(g, opt)(state, mesh.shard_batch(batch),
                            torch.Generator(device))
    nets = {"G": g, "D": d}
    out = {"grads": {}, "params": {}, "stats": {}}
    for n, net in nets.items():
        if net is None:
            continue
        for k, p in net.named_parameters():
            out["grads"][f"{n}.{k}"] = p.grad.cpu()
            out["params"][f"{n}.{k}"] = p.detach().cpu()
        for k, b in net.named_buffers():
            if "running" in k:
                out["stats"][f"{n}.{k}"] = b.cpu()
    torch.save(out, f"{args['out']}.{mesh.rank()}.pt")


def train(args):
    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.train import checkpoint as ckpt
    from realvsr_tpu_torch.train import trainer as trainer_mod

    opt = parse(args["opt"], is_train=True, root=args["root"])
    saves = []
    for name in ("save_network", "save_training_state"):
        inner = getattr(ckpt, name)

        def wrapped(*a, _inner=inner, _name=name, **kw):
            saves.append(_name)
            return _inner(*a, **kw)

        setattr(ckpt, name, wrapped)
    t = trainer_mod.Trainer(opt, device=args.get("device", "cpu"),
                            dcn_max_offset=8.0, backend=args.get("backend"))
    res = {"rank": mesh.rank(), "world": mesh.world_size(),
           "indices": t.train_loader.sampler.indices(0)[:64].tolist(),
           "per_rank_batch": t.train_loader.batch_size}
    if args.get("validate_first"):
        res["psnr0"] = t.validate(0)
    inner_step = t.train_step

    def counted(state, batch, gen):
        out = inner_step(state, batch, gen)
        if args.get("progress"):
            with open(f"{args['progress']}.{mesh.rank()}", "w") as f:
                f.write(str(t.current_step))
        return out

    t.train_step = counted
    t.train()
    res.update(step=t.current_step, saves=saves)
    with open(f"{args['out']}.{mesh.rank()}.json", "w") as f:
        json.dump(res, f)


def spatial(args):
    from realvsr_tpu_torch.eval.spatial import spatial_sharded_forward

    from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_fused
    from realvsr_tpu_torch.ops.kernels.dcn import dcn_fwd

    device = mesh.maybe_initialize_distributed(args.get("device", "cpu"),
                                               args.get("backend"))
    _, g, _ = _models(args, device)
    g.eval()
    window = torch.from_numpy(np.load(args["batch"])["window"]).to(device)
    kernels = {"dcn_fwd": dcn_fwd, "conv3x3": conv3x3,
               "conv3x3_fused": conv3x3_fused}
    before = {k: f.launches for k, f in kernels.items()}
    with torch.inference_mode():
        out = spatial_sharded_forward(g, window, halo=args["halo"])
    torch.save(out.cpu(), f"{args['out']}.{mesh.rank()}.pt")
    with open(f"{args['out']}.{mesh.rank()}.json", "w") as f:
        json.dump({k: fn.launches - before[k] for k, fn in kernels.items()},
                  f)


if __name__ == "__main__":
    torch.set_num_threads(1)
    # full f32 in cuDNN and matmuls, as the tests' one-process side runs
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    task, path = sys.argv[1], sys.argv[2]
    with open(path) as f:
        a = json.load(f)
    try:
        {"step": step, "train": train, "spatial": spatial}[task](a)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
