"""The cell-independent part of a run: finding a cell's files by name,
the tracing around the window, the per-layer readers, the check that no JAX
module was loaded, and the result line.

A driver (``drivers/<name>.py``, named by the traffic file) exposes
``run(ctx) -> Outcome``: it sets the cell up from ``ctx.seed``, warms up,
calls ``ctx.window()`` around its measured loop, reads the memory peak,
frees the program's state and checks what the timed path produced against
the plain reference.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# modules that must not be loaded by a run (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "realvsr_tpu")


@dataclass
class Cell:
    """One entry of ``workloads`` with its configuration and traffic files
    and the metrics it reports."""
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list
    limits: dict


def _reports(metric: dict, cell: str, e2e_names=None) -> bool:
    """Whether the cell reports the metric: those its ``workloads`` list, or
    without that key every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it ``moves`` (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(name: str, bench: dict | None = None,
              root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``) with its
    configuration, traffic mix and limits read from their files."""
    if bench is None:
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(HERE / "limits" / f"{name}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, config, traffic, int(w["chips"]), e2e, layer, limits)


def driver(cell: Cell):
    return importlib.import_module(
        f"portbench.drivers.{cell.traffic['driver']}")


@dataclass
class Readings:
    """What the per-layer readers read: the traced window's timeline, the
    kernel calls recorded in it (work per family), the units of work done
    (frames or steps), the model operations a unit, the compute dtype, and
    host-clock spans of the benchmark's loop."""
    window_s: float
    units: int
    flops_per_unit: int
    dtype: str
    timeline: object = None
    calls: dict = field(default_factory=dict)
    kernels: dict = field(default_factory=dict)
    host_spans: dict = field(default_factory=dict)


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict                   # end-to-end name -> value
    checks: dict                    # name -> (value, limit)
    memory_peak_bytes: int
    readings: Readings
    extra: dict = field(default_factory=dict)


class Context:
    """What a driver gets: the cell, the run's arguments, and the tracing
    around its window (``--trace 1``: the profiler and the kernel-call
    recorder)."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device, t_start: float, controls: bool = False):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.controls = controls   # also read the check's controls
        self.trace, self.device, self.t_start = trace, device, t_start
        self.setup_s = None
        self.prof = self.traced = None
        self.recorder = None

    def span(self, name: str):
        """A span of the benchmark's loop, recorded in the trace."""
        if self.prof is None:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(f"pb.{name}")

    @contextlib.contextmanager
    def window(self):
        """Around the measured loop: fixes ``setup_s`` at its start, and in
        a traced run profiles it and records the kernel calls."""
        import torch

        self.setup_s = time.perf_counter() - self.t_start
        if not self.trace:
            yield
            _sync(self.device)
            return
        from portbench.calls import Recorder

        self.recorder = Recorder()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        with self.prof, self.recorder.active():
            with torch.profiler.record_function("pb.window"):
                yield
            _sync(self.device)
        self.traced, self.prof = self.prof, None

    def timeline(self):
        from portbench.timeline import Timeline

        return Timeline(self.traced.profiler.kineto_results.events())


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def read_layer_metrics(cell: Cell, readings: Readings) -> dict:
    """{name: {"value", "unit"}} of every per-layer metric of the cell whose
    reader (``layer_metrics/<name>.py``) finds something to read."""
    out = {}
    for m in cell.per_layer:
        path = HERE / "layer_metrics" / f"{m['name']}.py"
        spec = importlib.util.spec_from_file_location(
            f"portbench.layer_metrics.{m['name']}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({k for k in sys.modules
                   if k.split(".")[0] in FORBIDDEN})


def device_info(device, n_used: int, peak: int, readings: Readings | None):
    import torch

    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": n_used, "memory_peak_bytes": int(peak)}
    if readings is not None and readings.timeline is not None:
        info["busy_s"] = readings.timeline.busy_s()
        info["window_s"] = readings.timeline.window_s()
    return info


def result_line(cell: Cell, out: Outcome, ctx: Context) -> dict:
    """The last line of standard output; ``checks`` comes last."""
    correct = (out.failed == 0 and bool(out.checks) and all(
        math.isfinite(v) and v <= lim for v, lim in out.checks.values()))
    if ctx.trace:
        out.readings.timeline = ctx.timeline()
        out.readings.calls = dict(ctx.recorder.work)
        out.readings.kernels = ctx.recorder.kernels
        metrics = read_layer_metrics(cell, out.readings)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out.metrics.items() if k in units}
        metrics["setup_s"] = {"value": ctx.setup_s, "unit": units["setup_s"]}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": device_info(ctx.device, cell.chips,
                                  out.memory_peak_bytes,
                                  out.readings if ctx.trace else None)}
    if ctx.trace:
        r = out.readings
        line["breakdown"] = r.timeline.breakdown()
        secs, by_name = r.timeline.family_device_s(r.kernels)
        # how the kernel families' device time was found: ops launched in
        # their call spans, or matched by name where a launch was missing
        line["attribution"] = {
            fam: {"calls": len(work), "device_s": secs.get(fam, 0.0),
                  "by_name": by_name.get(fam, 0)}
            for fam, work in r.calls.items()}
    line.update(out.extra)
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in out.checks.items()}
    return line


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, controls: bool = False) -> dict:
    """Run the cell once on ``device`` and return its result line
    (``controls``: with the readings of the check's controls and faults
    beside it, as ``portbench/calibrate.py`` takes them)."""
    ctx = Context(cell, seed, seconds, trace, device, t_start, controls)
    out = driver(cell).run(ctx)
    return result_line(cell, out, ctx)
