"""The port's spans and counters (``realvsr_tpu_torch/utils/trace.py``) on
the CPU: off without a profiler session, on in every thread with one; the
restore entry's, the loader's, the training step's and the kernels' spans
with their request ids, parents and attributes; the clock they share with
torch.profiler's events; the store's cap; ``tools/train.py --profile``'s
``spans.json``."""
import json
import os
import statistics
import threading
import time

import numpy as np
import pytest
import torch
import yaml
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from realvsr_tpu_torch.core import config
from realvsr_tpu_torch.data.loader import TrainLoader
from realvsr_tpu_torch.eval.sliding_window import sliding_window_infer
from realvsr_tpu_torch.models.edvr import EDVRNoUp
from realvsr_tpu_torch.ops.kernels.conv3x3 import conv3x3, conv3x3_autograd
from realvsr_tpu_torch.ops.kernels.dcn import (dcn_bwd_om, dcn_fwd,
                                               dcn_fwd_om)
from realvsr_tpu_torch.train.state import create_train_state
from realvsr_tpu_torch.train.trainer import Trainer
from realvsr_tpu_torch.train.wrappers import make_split_train_step
from realvsr_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEBUG = os.path.join(REPO, "configs", "train",
                     "debug_EDVR_woTSA_Split_synthetic.yml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _empty_store():
    trace.clear()
    yield
    trace.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _names(spans):
    return [s.name for s in spans]


def test_nothing_is_recorded_without_a_profiler_session():
    assert not autograd_profiler._is_profiler_enabled
    assert trace.span("restore.gather", (0, 0)) is trace.OFF
    x = torch.rand(1, 4, 4, 16)
    with trace.span("train.step", 1):
        conv3x3(x, torch.rand(16, 16, 3, 3))
    trace.count("loader.ready", 2)
    assert trace.spans() == [] and trace.counters() == []


def test_a_session_turns_recording_on_in_every_thread():
    """torch.autograd.profiler's module flag is what the store reads: the
    session sets it for the whole process, while the C-level flag is per
    thread and reads False on a thread the session did not start.  If a
    torch upgrade changes either, this fails."""
    seen = {}

    def worker():
        seen["flag"] = autograd_profiler._is_profiler_enabled
        seen["c_flag"] = torch._C._autograd._profiler_enabled()
        with trace.span("loader.fetch", (0, 0)):
            trace.count("loader.ready", 1)

    with _profiled():
        with trace.span("restore.upload", (0, 0)):
            pass
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen == {"flag": True, "c_flag": False}
    spans = {s.name: s for s in trace.spans()}
    assert spans.keys() == {"restore.upload", "loader.fetch"}
    assert spans["loader.fetch"].thread == t.native_id
    assert spans["restore.upload"].thread == threading.get_native_id()
    (c,) = trace.counters("loader.ready")
    assert (c.value, c.thread) == (1, t.native_id)
    assert not autograd_profiler._is_profiler_enabled


class _Tiny(torch.nn.Module):
    """A 16-wide conv over the window's frames stacked on channels."""

    def __init__(self, n_frames):
        super().__init__()
        g = torch.Generator().manual_seed(0)
        self.inp = torch.nn.Parameter(torch.rand(16, 3 * n_frames, 1, 1,
                                                 generator=g))
        self.conv = torch.nn.Parameter(torch.rand(16, 16, 3, 3,
                                                  generator=g) * 0.1)

    def forward(self, window):
        t, h, w, c = window.shape
        x = window.permute(1, 2, 0, 3).reshape(1, h, w, t * c)
        x = torch.einsum("bhwc,oc->bhwo", x, self.inp[:, :, 0, 0])
        return conv3x3(x.contiguous(), self.conv, act="relu")[0, ..., :3]


@pytest.mark.parametrize("flip_test", [False, True], ids=["plain", "flips"])
def test_restore_entry_spans_share_the_frames_request(flip_test):
    """One upload a clip; one gather, forward, wait and download a frame,
    each with the frame's (clip, index); the kernel calls under the
    forward, with its request and its id as their parent."""
    frames = np.random.default_rng(0).random((4, 8, 12, 3),
                                             dtype=np.float32)
    model = _Tiny(3)
    with _profiled(), torch.no_grad():
        out = list(sliding_window_infer(model, frames, 3, flip_test=flip_test,
                                        device="cpu"))
    assert [i for i, _ in out] == [0, 1, 2, 3]
    assert all(o.dtype == np.float32 and o.shape == (8, 12, 3)
               for _, o in out)
    spans = trace.spans()
    (upload,) = trace.spans("restore.upload")
    clip = upload.req[0]
    assert upload.req == (clip, 0) and upload.parent is None
    for phase in ("gather", "forward", "wait", "download"):
        got = trace.spans(f"restore.{phase}")
        assert [s.req for s in got] == [(clip, i) for i in range(4)], phase
        assert all(s.parent is None for s in got)
    fwd = {s.id: s for s in trace.spans("restore.forward")}
    calls = trace.spans("kernel.conv3x3")
    assert len(calls) == 4 * (4 if flip_test else 1)
    for k in calls:
        assert k.parent in fwd and k.req == fwd[k.parent].req
    for a, b in zip(trace.spans("restore.gather"),
                    trace.spans("restore.forward")):
        assert a.end_ns <= b.start_ns
    order = [s.name for s in sorted(spans, key=lambda s: s.start_ns)
             if s.name.startswith("restore.") and s.req == (clip, 1)]
    assert order == ["restore.gather", "restore.forward", "restore.wait",
                     "restore.download"]


@pytest.mark.parametrize("n,want", [(1, [0]), (2, [0, 0]), (4, [0, 0, 1, 1]),
                                    (6, [0, 0, 1, 1, 1, 1])])
def test_restore_ahead_counts_the_windows_launched_early(n, want):
    """``restore.ahead``: one sample a frame, 1 where the frame's window
    was launched before the caller asked for it."""
    frames = np.random.default_rng(n).random((n, 8, 12, 3),
                                             dtype=np.float32)
    with _profiled(), torch.no_grad():
        out = list(sliding_window_infer(_Tiny(3), frames, 3, device="cpu"))
    assert len(out) == n
    assert [c.value for c in trace.counters("restore.ahead")] == want


def test_run_ahead_spans_keep_their_frame():
    """Running one window ahead, each phase keeps one span a frame with its
    (clip, index); frame k+1's gather and forward run inside frame k's ask,
    after frame k's forward and before its wait.  Closed after three asks
    of six frames: four windows launched, three handed back."""
    frames = np.random.default_rng(1).random((6, 8, 12, 3),
                                             dtype=np.float32)
    with _profiled(), torch.no_grad():
        it = sliding_window_infer(_Tiny(3), frames, 3, device="cpu")
        asks = []
        for _ in range(3):
            a = time.time_ns()
            next(it)
            asks.append((a, time.time_ns()))
        it.close()
    (upload,) = trace.spans("restore.upload")
    clip = upload.req[0]
    by = {p: {s.req: s for s in trace.spans(f"restore.{p}")}
          for p in ("gather", "forward", "wait", "download")}
    for p, n in (("gather", 4), ("forward", 4), ("wait", 3),
                 ("download", 3)):
        assert [s.req for s in trace.spans(f"restore.{p}")] == [
            (clip, i) for i in range(n)], p
    for k in (1, 2):
        nxt = (clip, k + 1)
        a, b = asks[k]
        assert a <= by["gather"][nxt].start_ns
        assert by["forward"][(clip, k)].end_ns <= by["gather"][nxt].start_ns
        assert by["forward"][nxt].end_ns <= by["wait"][(clip, k)].start_ns
        assert by["download"][(clip, k)].end_ns <= b
    assert by["forward"][(clip, 1)].start_ns >= asks[1][0]


class _Toy:
    def __len__(self):
        return 6

    def get(self, index, rng):
        return {"LQs": np.full((3, 4, 4, 3), index, np.float32),
                "key": str(index)}


def test_loader_spans_pair_the_producers_batches_with_the_waits():
    loader = TrainLoader(_Toy(), batch_size=2, ratio=2, num_workers=2,
                         prefetch=2)
    with _profiled():
        batches = list(loader.epoch_iter(3))
    assert len(batches) == len(loader) == 6
    main = threading.get_native_id()
    fetch = trace.spans("loader.fetch")
    collate = trace.spans("loader.collate")
    waits = trace.spans("loader.wait")
    want = [(3, b) for b in range(6)]
    assert [s.req for s in fetch] == [s.req for s in collate] == want
    assert {s.thread for s in fetch + collate} != {main}
    assert [s.req for s in waits] == want + [(3, 6)]   # the last: the end
    assert all(s.thread == main for s in waits)
    by_req = {s.req: s for s in collate}
    for w in waits[:-1]:   # a batch is handed over after it is made
        assert by_req[w.req].end_ns <= w.end_ns
    puts = trace.spans("loader.put_wait")
    assert [s.req for s in puts][:6] == want
    ready = trace.counters("loader.ready")
    assert len(ready) == 7
    assert all(0 <= c.value <= loader.prefetch for c in ready)


def _debug_opt(**train):
    with open(DEBUG) as f:
        opt = yaml.safe_load(f)
    opt.pop("augment")
    opt["train"].update(train)
    return opt


def test_split_step_records_its_five_phases_in_order():
    opt = _debug_opt()
    net = {k: v for k, v in opt["network_G"].items()
           if k in ("nf", "nc", "nframes", "groups", "front_RBs",
                    "back_RBs", "w_TSA")}
    model = EDVRNoUp(**net, device="cpu", dcn_max_offset=8,
                     generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, opt)
    step = make_split_train_step(model, opt)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.random((2, 3, 32, 32, 3),
                                            dtype=np.float32))
             for k in ("LQs", "GT")}
    with _profiled():
        with trace.span("train.step", 7):
            step(state, batch, torch.Generator())
    (outer,) = trace.spans("train.step")
    phases = sorted((s for s in trace.spans()
                     if s.name.startswith("train.") and s is not outer),
                    key=lambda s: s.start_ns)
    assert _names(phases) == ["train.augment", "train.forward",
                              "train.loss", "train.backward",
                              "train.optimizer"]
    assert all(s.parent == outer.id and s.req == 7 for s in phases)
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns
    fwd, bwd = phases[1], phases[3]
    kernels = trace.spans()
    assert any(k.name == "kernel.conv3x3" and k.parent == fwd.id
               for k in kernels)
    # the backward's convs run inside the backward phase (on the CPU
    # autograd runs on the calling thread)
    assert any(k.name == "kernel.conv3x3_bwd"
               and bwd.start_ns <= k.start_ns <= k.end_ns <= bwd.end_ns
               for k in kernels)
    assert state.step == 1


def _key(b, h, w, cin, cout, cin2=0, groups=1, dtype="float32", act=None):
    return {"b": b, "h": h, "w": w, "cin": cin, "cin2": cin2, "cout": cout,
            "groups": groups, "dtype": dtype, "act": act}


def test_kernel_spans_carry_the_calls_shape():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(2, 6, 5, 16, generator=g)
    x2 = torch.rand(2, 6, 5, 32, generator=g)
    w = torch.rand(24, 48, 3, 3, generator=g) * 0.1
    xd = torch.rand(1, 5, 6, 32, generator=g)
    wd = torch.rand(16, 32, 3, 3, generator=g) * 0.1
    om = torch.randn(1, 5, 6, 4 * 27, generator=g)
    off, mask = om[..., :72].contiguous(), om[..., 72:].sigmoid()
    gout = torch.rand(1, 5, 6, 16, generator=g)
    with _profiled():
        conv3x3(x, w, act="lrelu", x2=x2)
        dcn_fwd(xd, off, mask, wd, None, 4, "relu", 4.0)
        dcn_fwd_om(xd, om, wd, None, 4)
        dcn_bwd_om(xd, om, wd, gout, 4)
    got = [(s.name, s.attrs) for s in trace.spans()]
    assert got == [
        ("kernel.conv3x3", _key(2, 6, 5, 16, 24, cin2=32, act="lrelu")),
        ("kernel.dcn_fwd", _key(1, 5, 6, 32, 16, groups=4, act="relu")),
        ("kernel.dcn_fwd", _key(1, 5, 6, 32, 16, groups=4)),
        ("kernel.dcn_bwd", _key(1, 5, 6, 32, 16, groups=4))]
    assert all(s.end_ns >= s.start_ns for s in trace.spans())


def test_conv3x3_autograd_backward_records_conv3x3_bwd_spans():
    """One span a cuDNN call of the backward: one for a single input, one
    per input for two."""
    g = torch.Generator().manual_seed(1)
    x = torch.rand(1, 6, 6, 16, generator=g, dtype=torch.float64)
    x2 = torch.rand(1, 6, 6, 32, generator=g, dtype=torch.float64)
    w = (torch.rand(8, 48, 3, 3, generator=g, dtype=torch.float64)
         ).requires_grad_()
    x.requires_grad_()
    with _profiled():
        conv3x3_autograd(x, w, x2=x2, act="relu").sum().backward()
    assert _names(trace.spans()) == ["kernel.conv3x3", "kernel.conv3x3_bwd",
                                     "kernel.conv3x3_bwd"]
    bwd = trace.spans("kernel.conv3x3_bwd")
    assert [s.attrs for s in bwd] == [
        _key(1, 6, 6, 16, 8, dtype="float64"),
        _key(1, 6, 6, 32, 8, dtype="float64")]
    assert x.grad is not None and w.grad.shape == w.shape


def test_phase_spans_are_on_the_profilers_clock():
    """A phase span's record and the profiler's event of the same span
    agree within 50 us at both ends.  Each end pairs two clock reads taken
    a few microseconds apart, so a preempted host can split one pair: the
    median of nine spans says whether the clocks agree."""
    with _profiled() as prof:
        with trace.span("restore.gather", (0, 0)):   # warms the path up
            pass
        for i in range(1, 10):
            with trace.span("restore.gather", (0, i)):
                torch.ones(64).sum()
    ours = {s.req[1]: s for s in trace.spans("restore.gather")}
    theirs = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.name() == "restore.gather"),
                    key=lambda e: e.start_ns())
    assert len(theirs) == len(ours) == 10
    starts, ends = [], []
    for i, e in enumerate(theirs[1:], 1):
        starts.append(abs(e.start_ns() - ours[i].start_ns))
        ends.append(abs(e.start_ns() + e.duration_ns() - ours[i].end_ns))
    assert statistics.median(starts) < 50_000, starts
    assert statistics.median(ends) < 50_000, ends


def test_the_store_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 3)
    with _profiled():
        for i in range(5):
            with trace.span("loader.fetch", (0, i)):
                pass
            trace.count("loader.ready", i)
    assert [s.req for s in trace.spans()] == [(0, 0), (0, 1), (0, 2)]
    assert [c.value for c in trace.counters()] == [0, 1, 2]
    assert trace.dropped() == {"spans": 2, "counters": 2}
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == {"spans": 0,
                                                       "counters": 0}


def test_profiled_training_writes_the_windows_spans(tmp_path):
    """``Trainer.profile_steps`` (``tools/train.py --profile``) empties the
    store as its window opens and writes ``spans.json`` beside
    ``trace.json`` as it closes: the loop's, the step's and the loader
    thread's spans of the window's steps, on the Unix-ns clock."""
    opt = _debug_opt(niter=4, val_freq=None)
    opt["datasets"].pop("val")
    opt["datasets"]["train"]["GT_size"] = 32
    path = tmp_path / "opt.yml"
    path.write_text(yaml.safe_dump(opt))
    trainer = Trainer(config.parse(str(path), is_train=True,
                                   root=str(tmp_path)),
                      device="cpu", dcn_max_offset=8.0)
    trainer.profile_steps = (2, 4)
    with _profiled():   # recorded before the window: emptied at its start
        with trace.span("train.step", -1):
            pass
    trainer.train()
    out = tmp_path / "experiments" / opt["name"] / "profile"
    assert (out / "trace.json").is_file()
    doc = json.loads((out / "spans.json").read_text())
    assert doc["clock"] == "unix_ns"
    assert doc["dropped"] == {"spans": 0, "counters": 0}
    steps = [s for s in doc["spans"] if s["name"] == "train.step"]
    assert [s["req"] for s in steps] == [2, 3]
    uploads = [s["req"] for s in doc["spans"] if s["name"] == "train.upload"]
    assert uploads == [2, 3]
    names = {s["name"] for s in doc["spans"]}
    assert {"train.forward", "train.backward", "train.optimizer",
            "loader.wait", "kernel.conv3x3"} <= names
    main = threading.get_native_id()
    assert any(s["name"] == "loader.collate" and s["thread"] != main
               for s in doc["spans"])
    assert doc["counters"] and all(c["name"] == "loader.ready"
                                   for c in doc["counters"])
    for s in doc["spans"]:
        assert 1.6e18 < s["start_ns"] <= s["end_ns"]
