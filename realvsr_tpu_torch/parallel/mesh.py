"""Process group and data-parallel helpers (``torch.distributed``).

Counterpart of ``realvsr_tpu/parallel/mesh.py``.  The JAX package runs one
jitted step over a batch sharded on a ``data`` mesh axis, and XLA inserts
the gradient all-reduce; ``jax.process_index() == 0`` gates logging and
checkpoints.  Here one process drives one device (or, for the CPU and for
a single card shared by several ranks, one share of it):

  * :func:`maybe_initialize_distributed` joins the process group that
    ``torchrun`` describes in ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
    ``MASTER_ADDR`` / ``MASTER_PORT``; without them it does nothing and the
    world is one process.  The backend is ``nccl`` for CUDA devices and
    ``gloo`` for the CPU unless the caller names one (``gloo`` also carries
    CUDA tensors, staged through the host, which lets several ranks share
    one card; NCCL refuses two ranks on one GPU);
  * :func:`shard_batch` takes a rank's rows of a global batch: contiguous
    blocks in rank order, as JAX's ``data`` axis lays them out;
  * :func:`all_reduce_sum`, :func:`all_reduce_mean`, :func:`all_gather_rows`
    and :func:`global_mean` are autograd-aware (``torch.distributed.nn.
    functional``): the backward of a summed tensor all-reduces its
    gradient, so a term coupled across the global batch (BatchNorm's
    statistics, RaGAN's batch means) gets, after :func:`average_gradients`,
    the gradient JAX takes of the global batch (see :func:`global_mean`);
  * :func:`average_gradients` averages the parameters' gradients over the
    ranks in one flat all-reduce before each optimizer update (what XLA
    inserts in JAX);
  * :func:`any_rank` all-reduces a host flag (a stop request) over a
    ``gloo`` group, so it never waits on the device.

Every helper is the identity (and issues no collective) in a world of one
process.
"""
from __future__ import annotations

import os
from typing import Any, Iterable, Mapping

import torch
import torch.distributed as dist

_HOST_GROUP = None   # a gloo group for host flags when the backend is not


def maybe_initialize_distributed(device="cuda",
                                 backend: str | None = None) -> torch.device:
    """Join torchrun's process group when its environment is set (no-op
    otherwise, or when a group exists); returns this rank's device:
    ``cuda:LOCAL_RANK`` (modulo the cards present, so ranks may share one)
    made current with ``torch.cuda.set_device``, or ``device`` as given."""
    global _HOST_GROUP
    device = torch.device(device)
    env = os.environ
    launched = "RANK" in env and "WORLD_SIZE" in env
    if device.type == "cuda" and device.index is None and launched:
        local = int(env.get("LOCAL_RANK", env["RANK"]))
        device = torch.device("cuda", local % torch.cuda.device_count())
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    if launched and not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        dist.init_process_group(backend, rank=int(env["RANK"]),
                                world_size=int(env["WORLD_SIZE"]))
        _HOST_GROUP = (None if backend == "gloo"
                       else dist.new_group(backend="gloo"))
    return device


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier(group=_HOST_GROUP)


def shard_batch(batch: Mapping[str, Any], rank_: int | None = None,
                world: int | None = None) -> dict:
    """This rank's rows of a global batch (tensors or arrays with the batch
    on axis 0): rank r of W takes rows [r B/W, (r+1) B/W)."""
    rank_ = rank() if rank_ is None else rank_
    world = world_size() if world is None else world
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"{k}: batch {v.shape[0]} does not split over "
                             f"{world} processes")
        n = v.shape[0] // world
        out[k] = v[rank_ * n:(rank_ + 1) * n]
    return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks; its gradient is the sum of the
    ranks' gradients of the result."""
    if world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(x)


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (autograd-aware)."""
    world = world_size()
    return x if world == 1 else all_reduce_sum(x) / world


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated on axis 0 in rank order (equal
    shapes; autograd-aware)."""
    if world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_gather

    return torch.cat(all_gather(x.contiguous()), 0)


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over its elements on every rank (equal shapes): a
    batch mean of the global batch, as JAX takes it over a ``data``-sharded
    array.  ``x.mean()`` itself in a world of one.

    Gradient.  Let rank r's loss be L_r = l_r(x_r, M) with M = S / N,
    S = sum_q s_q, s_q = sum of x_q and N every rank's elements; JAX's loss
    over the global batch is L = (1/W) sum_r L_r (each L_r a mean over
    equal shards).  Its gradient in x_q is (1/W) [dl_q/dx_q + (sum_r
    dl_r/dM) / N].  Rank q's backward gives dl_q/dx_q + g_S, where g_S is
    the gradient reaching s_q; the all-reduce's backward sums dl_r/dM / N
    over the ranks into g_S, and :func:`average_gradients` then divides
    the parameters' gradients by W: JAX's gradient.  The same holds for
    every statistic summed with :func:`all_reduce_sum` (BatchNorm's)."""
    world = world_size()
    if world == 1:
        return x.mean()
    return all_reduce_sum(x.sum()) / (x.numel() * world)


def average_gradients(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks (one flat
    all-reduce; parameters without a gradient are skipped, the same ones on
    every rank as every rank runs the same graph).  Every loss term of the
    training steps is a mean over the batch, so the mean of the ranks'
    gradients is the global batch's; a term summed over the batch would
    need scaling by the world size, and none is reached."""
    world = world_size()
    if world == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    dist.all_reduce(flat)
    flat /= world
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def broadcast_module(module: torch.nn.Module | None) -> None:
    """Give every rank rank 0's parameters and buffers."""
    if module is None or world_size() == 1:
        return
    with torch.no_grad():
        for t in (*module.parameters(), *module.buffers()):
            dist.broadcast(t.data, 0)


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any (a host all-reduce
    over ``gloo``)."""
    if world_size() == 1:
        return flag
    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_HOST_GROUP)
    return bool(t.item())


def gather_objects(obj) -> list:
    """Every rank's picklable ``obj``, in rank order (over ``gloo``)."""
    if world_size() == 1:
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj, group=_HOST_GROUP)
    return out
