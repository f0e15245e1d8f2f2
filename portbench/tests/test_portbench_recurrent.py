"""The BasicVSR++ cell (``basicvsrpp.restore_reds4``) on the CPU at a small
size: the reference's operation count against one worked layer by layer,
the check that decides ``correct`` (the program passes, the fp8 control and
an altered answer fail), and the readers of the recurrent entry's spans on
a hand-built store and timeline."""
import importlib.util
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.harness import Readings
from portbench.reference import basicvsrpp
from realvsr_tpu_torch.utils import trace
from realvsr_tpu_torch.utils.trace import Span

HERE = Path(__file__).resolve().parents[1]
CELL = "basicvsrpp.restore_reds4"
READERS = ("flow_ms.recurrent", "propagate_ms.recurrent",
           "propagate_idle_share.recurrent")


def _macs_per_clip(m, nb, t, h, w):
    """Multiply-accumulates of one clip, worked from the layer list."""
    px = h * w
    blocks = lambda n: n * 2 * 9 * m * m            # noqa: E731
    total = t * px * (9 * 3 * m + blocks(5))        # feat_extract
    spy = sum(49 * (8 * 32 + 32 * 64 + 64 * 32 + 32 * 16 + 16 * 2)
              * (h // 2 ** k) * (w // 2 ** k) for k in range(6))
    total += 2 * (t - 1) * spy                      # both directions
    for i in range(4):
        step = 9 * (2 + i) * m * m + blocks(nb)     # backbone
        align = 9 * ((3 * m + 4) * m + 2 * m * m + m * 27 * 16) \
            + 9 * 2 * m * m                         # offsets + DCN
        total += px * (t * step + (t - 1) * align)
    head = px * (9 * 5 * m * m + blocks(5) + 9 * m * 4 * m) \
        + 4 * px * 9 * m * 256 + 16 * px * 9 * (64 * 64 + 64 * 3)
    return total + t * head


def test_model_flops_counts_every_layer():
    net = dict(mid_channels=16, num_blocks=2, max_residue_magnitude=10,
               is_low_res_input=True)
    got = basicvsrpp.model_flops(net, (1, 3, 64, 96, 3))
    assert got == 2 * _macs_per_clip(16, 2, 3, 64, 96) // 3


def _small():
    cell = harness.load_cell(CELL)
    cell.config["network_G"].update(mid_channels=16, num_blocks=1)
    cell.config["restore_size"] = [64, 64]
    cell.traffic.update(clips=2, frames_per_clip=5)
    return cell


def _run(cell, seed, controls=False, seconds=1.0):
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            time.perf_counter(), controls)


def test_program_passes_and_control_fails():
    line = _run(_small(), 2 ** 31 + 5, controls=True)
    assert line["correct"], line["checks"]
    assert line["checked_frames"] >= 1
    assert line["fp8_frame_gap"] > line["checks"]["frame_gap"]["limit"]


def test_altered_answer_fails():
    """Each frame replaced by the one before it."""
    from realvsr_tpu_torch.tools import _cli

    orig = _cli.restorer

    def stale(args, opt, model):
        inner = orig(args, opt, model)

        def restore(frames):
            prev = None
            for idx, out in inner(frames):
                yield idx, out if prev is None else prev
                prev = out
        return restore

    _cli.restorer = stale
    try:
        line = _run(_small(), 11, seconds=3.0)   # frames past the first
    finally:
        _cli.restorer = orig
    assert line["checked_frames"] >= 2
    assert not line["correct"], line["checks"]


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench.layer_metrics.{name}",
        HERE / "layer_metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.fixture
def store(monkeypatch):
    spans = []
    monkeypatch.setattr(trace, "spans", lambda name=None: [
        s for s in spans if name is None or s.name == name])
    return spans


def _span(name, start, end, **attrs):
    return Span(0, None, name, None, 1, start, end, attrs)


def _readings(device, launch, t0=0, t1=1000):
    tl = SimpleNamespace(t0=t0, t1=t1, device=sorted(device),
                         launch=launch)
    return Readings(window_s=1e-6, units=7, flops_per_unit=1,
                    dtype="bfloat16", timeline=tl)


def test_readers_on_a_hand_built_trace(store):
    """Two clips of 10 and 6 frames; device ops attributed by their launch
    time to the span holding it; idle time inside the propagate spans."""
    store += [_span("restore.flow", 100, 150, frames=10),
              _span("restore.propagate", 150, 300, branch="backward_1"),
              _span("restore.flow", 500, 520, frames=6),
              _span("restore.propagate", 520, 600, branch="backward_1")]
    # (start, end, name, correlation id); launches: id -> (host ns, thread)
    device = [(160, 260, "dcn", 1), (300, 400, "conv", 2),
              (505, 545, "spynet", 3), (560, 580, "conv", 4),
              (700, 800, "head", 5)]
    launch = {1: (110, 1), 2: (160, 1), 3: (510, 1), 4: (530, 1),
              5: (650, 1)}
    r = _readings(device, launch)
    # flow: ops 1 and 3 (140 ns) over 16 frames; propagate: 2 and 4
    assert _reader("flow_ms.recurrent")(r) == pytest.approx(
        1e-6 * 140 / 16)
    assert _reader("propagate_ms.recurrent")(r) == pytest.approx(
        1e-6 * 120 / 16)
    # propagate spans: [150, 300] idle 150-160 and 260-300; [520, 600]
    # idle 545-560 and 580-600: 85 of 230 ns
    assert _reader("propagate_idle_share.recurrent")(r) == pytest.approx(
        100 * 85 / 230)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_spans(store, name):
    r = _readings([(0, 10, "k", 1)], {1: (5, 1)})
    assert _reader(name)(r) is None
    assert _reader(name)(Readings(1.0, 1, 1, "bfloat16")) is None
