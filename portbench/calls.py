"""Records the calls into each kernel family during a traced window.

Each family file ``roofline/<family>.py`` names the port's entry point it
measures (``ENTRY``: module and function), the short names of the kernels
that entry launches (``KERNELS``) and ``work(bound_args, out)``: the bytes
and operations the call needs.  While :meth:`Recorder.active` is open, each
entry is replaced in its module by a wrapper that opens a
``pb.call.<family>`` span around the call (the timeline attributes the
device ops launched inside it) and keeps the call's work.  The port's own
callers look the entry up in its module at each call, so they reach the
wrapper; attributes of the function (its launch counters) are carried over
and back.
"""
from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
from collections import defaultdict
from pathlib import Path

FAMILIES = Path(__file__).resolve().parent / "roofline"


def families() -> dict:
    """{family: module} of every file under ``roofline/``."""
    return {p.stem: importlib.import_module(f"portbench.roofline.{p.stem}")
            for p in sorted(FAMILIES.glob("*.py")) if p.stem != "__init__"}


class Recorder:
    def __init__(self):
        self.work = defaultdict(list)   # family -> [(bytes, tc, f32, dtype)]
        self.kernels = {}               # family -> short kernel names

    def _wrap(self, fam: str, mod, fn):
        import torch

        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(f"pb.call.{fam}"):
                out = fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            self.work[fam].append(mod.work(bound.arguments, out))
            return out

        return wrapper

    @contextlib.contextmanager
    def active(self):
        patched = []
        try:
            for fam, mod in families().items():
                self.kernels[fam] = mod.KERNELS
                owner = importlib.import_module(mod.ENTRY[0])
                fn = getattr(owner, mod.ENTRY[1])
                setattr(owner, mod.ENTRY[1], self._wrap(fam, mod, fn))
                patched.append((owner, mod.ENTRY[1], fn))
            yield self
        finally:
            for owner, attr, fn in reversed(patched):
                fn.__dict__.update(getattr(owner, attr).__dict__)
                del fn.__dict__["__wrapped__"]
                setattr(owner, attr, fn)
