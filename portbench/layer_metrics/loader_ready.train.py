"""Mean batches waiting in the loader's queue when the trainer asked for
the next one (the port's ``loader.ready`` counter, ``qsize()`` at each
get) over the traced window: the prefetch depth when the loader keeps
ahead, near 0 when it falls behind.  None where the port records no such
counter."""


def read(r):
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own counters
        return None
    ready = trace.counters("loader.ready")
    return sum(c.value for c in ready) / len(ready) if ready else None
