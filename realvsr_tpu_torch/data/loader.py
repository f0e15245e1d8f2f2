"""Host data loading: iteration sampling, threaded decode, prefetch.

A copy of ``realvsr_tpu/data/loader.py`` (the reference's DataLoader-worker
pipeline, ``codes/data/__init__.py`` + ``data_sampler.py``):

  * :class:`IterationSampler` — the DistIterSampler semantics (dataset
    virtually enlarged ``ratio`` times, epoch-seeded permutation,
    process-strided subsample; data_sampler.py:46-59),
  * :class:`TrainLoader` — thread-pooled ``get`` calls with a bounded
    prefetch queue and a per-(seed, epoch, position) numpy RNG.  A failure
    in the producer thread is handed to the consumer, which raises it; a
    consumer that stops early stops the producer.  Traced
    (:mod:`~realvsr_tpu_torch.utils.trace`): the producer's
    ``loader.fetch``, ``loader.collate`` and ``loader.put_wait`` (blocked
    on a full queue), the consumer's ``loader.wait``, all with ``req``
    (epoch, batch index), and the counter ``loader.ready`` (batches in the
    queue at each get),
  * :class:`EvalLoader` — sequential batch-1 loading for validation.
"""
from __future__ import annotations

import itertools
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np

from realvsr_tpu_torch.utils import trace


def collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        out[k] = np.stack(vals, axis=0) if isinstance(vals[0], np.ndarray) \
            else vals
    return out


class IterationSampler:
    """Epoch-seeded, process-strided index stream over an enlarged dataset."""

    def __init__(self, dataset_size: int, num_replicas: int = 1, rank: int = 0,
                 ratio: int = 100):
        self.dataset_size = dataset_size
        self.num_replicas = num_replicas
        self.rank = rank
        total = dataset_size * ratio
        self.num_samples = int(np.ceil(total / num_replicas))
        self.total_size = self.num_samples * num_replicas

    def indices(self, epoch: int) -> np.ndarray:
        g = np.random.default_rng(epoch)
        idx = g.permutation(self.total_size) % self.dataset_size
        return idx[self.rank:self.total_size:self.num_replicas]


class _Failure:
    def __init__(self, exc: BaseException):
        self.exc = exc


class TrainLoader:
    """Iterator over host batches (numpy)."""

    def __init__(self, dataset, batch_size: int, num_replicas: int = 1,
                 rank: int = 0, ratio: int = 200, num_workers: int = 4,
                 prefetch: int = 2, seed: int = 0):
        if batch_size % num_replicas:
            raise ValueError("the global batch size must divide the number "
                             "of processes")
        self.dataset = dataset
        self.batch_size = batch_size // num_replicas
        self.sampler = IterationSampler(len(dataset), num_replicas, rank, ratio)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.seed = seed

    def __len__(self) -> int:
        return self.sampler.num_samples // self.batch_size

    def epoch_iter(self, epoch: int) -> Iterator[dict]:
        indices = self.sampler.indices(epoch)
        n_batches = len(indices) // self.batch_size
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        done = object()
        cancel = threading.Event()

        def fetch_sample(args):
            pos, idx = args
            rng = np.random.default_rng((self.seed, epoch, int(pos)))
            if hasattr(self.dataset, "get"):
                return self.dataset.get(int(idx), rng)
            return self.dataset[int(idx)]

        def put(item, req=None) -> bool:
            with trace.span("loader.put_wait", req):
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        return True
                    except queue.Full:
                        continue
            return False

        def producer():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(n_batches):
                        req = (epoch, b)
                        chunk = indices[b * self.batch_size:
                                        (b + 1) * self.batch_size]
                        args = [(b * self.batch_size + i, ix)
                                for i, ix in enumerate(chunk)]
                        with trace.span("loader.fetch", req):
                            samples = list(pool.map(fetch_sample, args))
                        with trace.span("loader.collate", req):
                            batch = collate(samples)
                        if not put(batch, req):
                            return
            except Exception as exc:  # the consumer raises it
                put(_Failure(exc))
                return
            put(done, (epoch, n_batches))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            for b in itertools.count():
                trace.count("loader.ready", q.qsize())
                with trace.span("loader.wait", (epoch, b)):
                    item = q.get()
                if item is done:
                    break
                if isinstance(item, _Failure):
                    raise RuntimeError("train loader failed") from item.exc
                yield item
        finally:
            cancel.set()
            t.join(timeout=30)


class EvalLoader:
    """Sequential batch-1 loader for validation/test datasets."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        for i in range(len(self.dataset)):
            item = self.dataset[i]
            yield {k: (v[None] if isinstance(v, np.ndarray) else [v])
                   for k, v in item.items()}
