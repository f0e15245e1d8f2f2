"""The readers of the port's spans and counters (``layer_metrics/``) on a
hand-built store and timeline, against values worked by hand; and each
reads nothing, without raising, from a port that has no such store."""
import importlib.util
import sys
import threading
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.harness import Readings
from realvsr_tpu_torch.utils import trace
from realvsr_tpu_torch.utils.trace import Counter, Span

HERE = Path(__file__).resolve().parents[1]
MAIN = threading.main_thread().native_id
READERS = ("download_ms.restore", "download_idle_share.restore",
           "kernel_call_us.restore", "conv_bwd_ms.train",
           "loader_batch_ms.train", "loader_ready.train")


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"portbench.layer_metrics.{name}",
        HERE / "layer_metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _span(name, start, end, req=None, thread=MAIN):
    return Span(0, None, name, req, thread, start, end, {})


@pytest.fixture
def store(monkeypatch):
    """Replace the store's readers by ones over the lists returned."""
    spans, counters = [], []

    def read_spans(name=None):
        return [s for s in spans if name is None or s.name == name]

    def read_counters(name=None):
        return [c for c in counters if name is None or c.name == name]

    monkeypatch.setattr(trace, "spans", read_spans)
    monkeypatch.setattr(trace, "counters", read_counters)
    return spans, counters


def _readings(timeline=None, units=1):
    return Readings(window_s=1.0, units=units, flops_per_unit=1,
                    dtype="bfloat16", timeline=timeline)


def _timeline(t0, t1, device=(), launch=None):
    return SimpleNamespace(t0=t0, t1=t1, device=list(device),
                           launch=dict(launch or {}))


def test_download_ms_is_the_mean_download(store):
    spans, _ = store
    spans += [_span("restore.download", 0, 2_000_000, (0, 0)),
              _span("restore.download", 5_000_000, 9_000_000, (0, 1)),
              _span("restore.wait", 2_000_000, 5_000_000, (0, 1))]
    assert _reader("download_ms.restore")(_readings()) == pytest.approx(3.0)


def test_download_idle_share_counts_idle_time_inside_main_downloads(store):
    """Window 0-1000; the device busy over 100-400 (two ops overlapping)
    and 600-700; main-thread downloads 200-500 (idle 400-500: 100) and
    650-900 (idle 700-900: 200); another thread's download over the whole
    window is left out: 300 / 1000 = 30%."""
    spans, _ = store
    spans += [_span("restore.download", 200, 500),
              _span("restore.download", 650, 900),
              _span("restore.download", 0, 1000, thread=MAIN + 1)]
    tl = _timeline(0, 1000, [(100, 300, "k", 1), (250, 400, "k", 2),
                             (600, 700, "k", 3)])
    got = _reader("download_idle_share.restore")(_readings(tl))
    assert got == pytest.approx(30.0)


def test_download_idle_share_clips_to_the_window(store):
    """A download over 900-1200 in a window ending at 1000, the device idle
    throughout: 100 of 1000."""
    spans, _ = store
    spans.append(_span("restore.download", 900, 1200))
    tl = _timeline(0, 1000, [(0, 900, "k", 1)])
    got = _reader("download_idle_share.restore")(_readings(tl))
    assert got == pytest.approx(10.0)


def test_kernel_call_us_is_the_mean_forward_kernel_call(store):
    spans, _ = store
    spans += [_span("kernel.conv3x3", 0, 10_000),
              _span("kernel.conv3x3", 20_000, 50_000),
              _span("kernel.dcn_fwd", 60_000, 80_000),
              _span("kernel.dcn_bwd", 0, 1_000_000)]
    assert _reader("kernel_call_us.restore")(_readings()) == \
        pytest.approx(20.0)


def test_conv_bwd_ms_sums_the_device_ops_launched_in_the_spans(store):
    """Spans 100-200 and 300-400; launches at 150 and 400 fall inside (ops
    of 1 and 3 ms), at 250 and 50 outside (5 and 7 ms); an op whose launch
    is not in the trace (9 ms) is left out: 4 ms over 2 steps."""
    spans, _ = store
    spans += [_span("kernel.conv3x3_bwd", 300, 400, thread=7),
              _span("kernel.conv3x3_bwd", 100, 200, thread=7)]
    ms = 1_000_000
    tl = _timeline(0, 10 ** 9,
                   [(1000, 1000 + ms, "wgrad", 1),
                    (3000, 3000 + 5 * ms, "x", 2),
                    (9000, 9000 + 3 * ms, "dgrad", 3),
                    (20000, 20000 + 7 * ms, "y", 4),
                    (40000, 40000 + 9 * ms, "z", 5)],
                   {1: (150, 7), 2: (250, 7), 3: (400, 7), 4: (50, 1)})
    got = _reader("conv_bwd_ms.train")(_readings(tl, units=2))
    assert got == pytest.approx(2.0)


def test_loader_batch_ms_takes_the_batches_with_both_spans(store):
    """(0, 0): 10 + 2 ms; (0, 1): 20 + 4 ms; (0, 2): only its collate (its
    fetch began before the window), left out: 18 ms."""
    spans, _ = store
    ms = 1_000_000
    spans += [_span("loader.fetch", 0, 10 * ms, (0, 0), 9),
              _span("loader.collate", 10 * ms, 12 * ms, (0, 0), 9),
              _span("loader.fetch", 12 * ms, 32 * ms, (0, 1), 9),
              _span("loader.collate", 32 * ms, 36 * ms, (0, 1), 9),
              _span("loader.collate", 40 * ms, 41 * ms, (0, 2), 9),
              _span("loader.wait", 0, 50 * ms, (0, 0))]
    assert _reader("loader_batch_ms.train")(_readings()) == \
        pytest.approx(18.0)


def test_loader_ready_is_the_mean_queue_depth_at_a_get(store):
    _, counters = store
    counters += [Counter("loader.ready", v, MAIN, t)
                 for t, v in enumerate((2, 2, 1, 0))]
    counters.append(Counter("other", 9, MAIN, 9))
    assert _reader("loader_ready.train")(_readings()) == pytest.approx(1.25)


@pytest.mark.parametrize("name", READERS)
def test_an_empty_store_reads_nothing(store, name):
    tl = _timeline(0, 1000, [(0, 10, "k", 1)], {1: (5, MAIN)})
    assert _reader(name)(_readings(tl)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_store_reads_nothing(monkeypatch, name):
    """A port that has no ``utils/trace.py`` (the import fails): None, no
    error."""
    monkeypatch.setitem(sys.modules, "realvsr_tpu_torch.utils.trace", None)
    monkeypatch.delattr(sys.modules["realvsr_tpu_torch.utils"], "trace")
    tl = _timeline(0, 1000, [(0, 10, "k", 1)], {1: (5, MAIN)})
    assert _reader(name)(_readings(tl)) is None
