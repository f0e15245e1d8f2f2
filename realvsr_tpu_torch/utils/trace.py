"""Spans and counters of the port's layers, on while a torch.profiler
session is open.

    with trace.span("restore.download", req=(clip, idx)):
        ...
    trace.count("loader.ready", q.qsize())

A span records its name, the id of the span enclosing it on the same
thread (its parent), a request id ``req`` (by default its parent's, so the
work of one frame or batch shares one), the thread's native id, its start
and end in Unix nanoseconds (``time.time_ns()``, the clock Kineto puts its
host and device events on, so the spans line up with a profiler trace
with no conversion) and its attributes.  Spans named ``restore.*`` or
``train.*`` (the phases of the restore entry and of a training step) also
open a profiler range of the same name, so an exported Chrome trace shows
them on their thread; the others (kernel calls, the loader's thread) go to
the store alone.  The range is an op-scope one
(``torch._C._profiler._RecordFunctionFast``, as torch's compiled kernels
record their launches), not ``record_function``: a user annotation gets a
device-side copy over the kernels it launches, which a reader of the
device timeline would take for device work.  :func:`kernel` opens a span
with a kernel call's shape as its attributes.

Recording is on exactly while a profiler session is open anywhere in the
process: ``torch.autograd.profiler._is_profiler_enabled``, which the
session sets for every thread (the C-level flag is per thread and reads
False on threads the session did not start, such as the loader's).  With
it off a span costs that one read and returns a shared no-op context.

Records live in memory, one store a process, up to :data:`CAP` spans and
:data:`CAP` counter samples; past that they are dropped and counted
(:func:`dropped`).  Nothing is written until asked: :func:`spans` and
:func:`counters` read the records, :func:`clear` empties them and
:func:`save` writes them as JSON.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import threading
import time
from typing import Any, NamedTuple

import torch
from torch.autograd import profiler as _profiler

CAP = 2 ** 20
PHASES = ("restore.", "train.")   # spans the profiler's trace shows too
OFF = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    parent: int | None
    name: str
    req: Any
    thread: int
    start_ns: int
    end_ns: int
    attrs: dict


class Counter(NamedTuple):
    name: str
    value: float
    thread: int
    t_ns: int


_lock = threading.Lock()
_spans: list[Span] = []
_counters: list[Counter] = []
_dropped = [0, 0]                 # spans, counter samples
_ids = itertools.count(1)
_local = threading.local()        # .stack, .tid: the thread's open spans
                                  # and native id (a system call to read)


def _thread() -> tuple[list, int]:
    """(the open spans, the native id) of the calling thread."""
    try:
        return _local.stack, _local.tid
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack, _local.tid


def _keep(store: list, rec, slot: int) -> None:
    with _lock:
        if len(store) < CAP:
            store.append(rec)
        else:
            _dropped[slot] += 1


class _Span:
    __slots__ = ("name", "req", "attrs", "id", "parent", "start", "rf",
                 "stack", "tid")

    def __init__(self, name: str, req, attrs: dict):
        self.name, self.req, self.attrs = name, req, attrs

    def __enter__(self):
        stack, self.tid = _thread()
        self.stack = stack
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.req is None and top is not None:
            self.req = top.req
        self.id = next(_ids)
        self.rf = None
        self.start = time.time_ns()
        if self.name.startswith(PHASES):
            self.rf = torch._C._profiler._RecordFunctionFast(self.name)
            self.rf.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        end = time.time_ns()
        _keep(_spans, Span(self.id, self.parent, self.name, self.req,
                           self.tid, self.start, end, self.attrs), 0)
        return False


def span(name: str, req=None, **attrs):
    """A context recording one span while a profiler session is open."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Span(name, req, attrs)


def kernel(name: str, x: torch.Tensor, weight: torch.Tensor,
           x2: torch.Tensor | None = None, groups: int = 1,
           act: str | None = None):
    """:func:`span` of one kernel call, its attributes the call's shape
    key: the NHWC input's b, h, w and cin, a second input's width cin2,
    cout (the weight's first dimension), groups, dtype and act."""
    if not _profiler._is_profiler_enabled:
        return OFF
    b, h, w, cin = x.shape if x.dim() == 4 else (-1, -1, -1, -1)
    return _Span(name, None, {
        "b": b, "h": h, "w": w, "cin": cin,
        "cin2": 0 if x2 is None else x2.shape[-1], "cout": weight.shape[0],
        "groups": groups, "dtype": str(x.dtype).removeprefix("torch."),
        "act": act})


def count(name: str, value: float = 1) -> None:
    """Record one sample of a counter while a profiler session is open."""
    if _profiler._is_profiler_enabled:
        _keep(_counters, Counter(name, value, _thread()[1], time.time_ns()),
              1)


def spans(name: str | None = None) -> list[Span]:
    """The recorded spans (of one name), in the order they ended."""
    with _lock:
        out = list(_spans)
    return out if name is None else [s for s in out if s.name == name]


def counters(name: str | None = None) -> list[Counter]:
    """The recorded counter samples (of one name), in time order."""
    with _lock:
        out = list(_counters)
    return out if name is None else [c for c in out if c.name == name]


def dropped() -> dict:
    """Records dropped past :data:`CAP`: {"spans": n, "counters": n}."""
    with _lock:
        return {"spans": _dropped[0], "counters": _dropped[1]}


def clear() -> None:
    """Empty the store (spans still open are kept when they end)."""
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped[0] = _dropped[1] = 0


def save(path: str) -> None:
    """Write the store as JSON: {"clock": "unix_ns", "spans": [...],
    "counters": [...], "dropped": {...}}, each record an object of its
    fields."""
    doc = {"clock": "unix_ns",
           "spans": [s._asdict() for s in spans()],
           "counters": [c._asdict() for c in counters()],
           "dropped": dropped()}
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
