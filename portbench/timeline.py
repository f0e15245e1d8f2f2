"""The traced window's device timeline, read from torch.profiler's events.

* Device work: every kernel, memcpy and memset the card ran, with its
  interval.
* Launches: each device op's host-side runtime call (by correlation id),
  whose time and thread say which of the benchmark's spans launched it.
* Spans: the benchmark's own ``record_function`` ranges, named ``pb.*``:
  ``pb.window`` (the measured loop), phases of the loop (``pb.frame``,
  ``pb.forward``, ``pb.loader_wait``, ``pb.upload``, ``pb.train_step``) and
  one ``pb.call.<family>`` around each call into a kernel family
  (``portbench/calls.py``).

Kineto puts host and device events on one clock, so a device op belongs to
the call span that holds its launch, and an idle gap of the device is
charged to the innermost phase span the host was in when it began.
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict

_DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
PHASE = "pb."
CALL = "pb.call."
_API = re.compile(r"^cu(da)?[A-Z]")


def _kind(e) -> str:
    """Kineto's activity type of an event; where the event does not say
    (older torch), worked out from its device and name: device ops are on
    the CUDA device (their copies of the benchmark's spans aside), launches
    are the runtime and driver API calls, spans are the ``pb.`` ranges."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if name.startswith(PHASE):
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        return "gpu_memset" if name.startswith("Memset") else "kernel"
    if name.startswith(PHASE):
        return "user_annotation"
    return "cuda_runtime" if _API.match(name) else "cpu_op"


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, its template
    arguments and its parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name[:80]


def _union(intervals) -> list[tuple[int, int]]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Timeline:
    def __init__(self, events):
        self.device = []      # (start_ns, end_ns, name, correlation id)
        launch = {}           # correlation id -> (host ns, thread)
        spans = []            # (start_ns, end_ns, name, thread)
        for e in events:
            kind = _kind(e)
            if kind in _DEVICE_KINDS:
                s = e.start_ns()
                self.device.append((s, s + e.duration_ns(), e.name(),
                                    e.correlation_id()))
            elif kind in _LAUNCH_KINDS:
                launch[e.correlation_id()] = (e.start_ns(),
                                              e.start_thread_id())
            elif kind == "user_annotation" and e.name().startswith(PHASE):
                s = e.start_ns()
                spans.append((s, s + e.duration_ns(), e.name(),
                              e.start_thread_id()))
        self.device.sort()
        self.launch = launch
        wins = [s for s in spans if s[2] == "pb.window"]
        if len(wins) != 1:
            raise RuntimeError(f"{len(wins)} pb.window spans in the trace")
        self.t0, self.t1 = wins[0][0], wins[0][1]
        self.calls = sorted(s for s in spans if s[2].startswith(CALL))
        self.phases = sorted(s for s in spans
                             if not s[2].startswith(CALL)
                             and s[2] != "pb.window")
        self._starts = [s[0] for s in self.calls]
        self._phase_starts = [s[0] for s in self.phases]
        self._busy = _union((max(s, self.t0), min(e, self.t1))
                            for s, e, _, _ in self.device
                            if e > self.t0 and s < self.t1)

    # ---- the device as a whole -------------------------------------------
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device
        (the union of their intervals)."""
        return sum(e - s for s, e in self._busy) / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s() / self.window_s()

    # ---- kernel families ---------------------------------------------------
    def _call_of(self, corr: int) -> str | None:
        """The family of the call span that launched device op ``corr`` (""
        outside every call span), or None where its launch is not in the
        trace."""
        hit = self.launch.get(corr)
        if hit is None:
            return None
        t, thread = hit
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0:
            s, e, name, th = self.calls[i]
            if t <= e and th == thread:
                return name[len(CALL):]
        return ""

    def family_device_s(self, kernel_names: dict) -> tuple[dict, dict]:
        """({family: device seconds}, {family: ops matched by name}).

        A device op belongs to the family whose call span launched it.  An
        op whose launch is missing from the trace is matched by its short
        name without namespaces (``kernel_names``: family -> names); a name
        that several
        families share goes with the next op on the device."""
        owner = defaultdict(list)
        for fam, names in kernel_names.items():
            for n in names:
                owner[n].append(fam)
        fams, named = [], []
        for _, _, name, corr in self.device:
            fam = self._call_of(corr)
            named.append(fam is None)
            if fam is None:
                cands = owner.get(short_name(name).split("::")[-1], [])
                fam = cands[0] if len(cands) == 1 else ("" if not cands
                                                       else None)
            fams.append(fam)
        nxt = ""
        for i in reversed(range(len(fams))):
            if fams[i] is None:
                fams[i] = nxt
            nxt = fams[i]
        secs, by_name = defaultdict(float), defaultdict(int)
        for (s, e, _, _), fam, nm in zip(self.device, fams, named):
            if fam:
                secs[fam] += (e - s) / 1e9
                by_name[fam] += nm
        return dict(secs), dict(by_name)

    def memcpy_s(self, prefix: str = "Memcpy HtoD") -> float:
        return sum(e - s for s, e, name, _ in self.device
                   if name.startswith(prefix)) / 1e9

    # ---- the breakdown --------------------------------------------------------
    def top_ops(self, n: int = 10) -> list:
        tot = defaultdict(int)
        for s, e, name, _ in self.device:
            if e > self.t0 and s < self.t1:
                tot[short_name(name)] += e - s
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def _phase_at(self, t: int) -> str:
        """The innermost phase span holding host time ``t`` (phases nest
        only a few deep, so a short look back from the last start finds
        it)."""
        i = bisect.bisect_right(self._phase_starts, t) - 1
        for j in range(i, max(i - 8, -1), -1):
            s, e, name, _ = self.phases[j]
            if e >= t:
                return name[len(PHASE):]
        return "outside_spans"

    def idle_gaps(self, n: int = 10) -> list:
        """Idle seconds of the device, summed by what the host was doing
        when each gap began, the largest first."""
        tot = defaultdict(int)
        edges = [(self.t0, self.t0)] + self._busy + [(self.t1, self.t1)]
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b > a:
                tot[self._phase_at(a)] += b - a
        return [[k, v / 1e9] for k, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}
