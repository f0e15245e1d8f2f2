"""BasicVSR++ in the port (``models/basicvsr_pp.py``) and its restore entry
(``eval/recurrent.py``) on the CPU: the model against the benchmark's
plain reference on seeded weights, the alignment's offset layout on a known
answer, the whole-clip restore against the model's forward, the restore
CLI's dispatch, and the entry's spans."""
import argparse
import json
import os
import sys

import cv2
import numpy as np
import pytest
import torch
import yaml
from torch.profiler import ProfilerActivity, profile

from realvsr_tpu_torch.eval.recurrent import (graphs, recurrent_infer,
                                              step_key)
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.models.basicvsr_pp import (
    BRANCHES, SecondOrderDeformableAlignment)
from realvsr_tpu_torch.models.common import reset_parameters
from realvsr_tpu_torch.ops.warp import flow_warp
from realvsr_tpu_torch.tools import _cli
from realvsr_tpu_torch.utils import trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)   # the benchmark's reference lives at the root

from portbench.drivers.restore_recurrent import make_weights  # noqa: E402
from portbench.reference import basicvsrpp as ref  # noqa: E402

YAML = os.path.join(REPO, "configs", "test", "test_BasicVSRPP_REDS4.yml")
SMALL = dict(which_model_G="BasicVSRPlusPlus", mid_channels=16,
             num_blocks=1, max_residue_magnitude=10, is_low_res_input=True)


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


def _model(net=SMALL, seed=3):
    """The port's model on seeded weights (the benchmark cell's draw and
    gains: a stable recurrence) and those weights."""
    with open(os.path.join(REPO, "portbench", "configs",
                           "basicvsrpp.json")) as f:
        cfg = json.load(f)
    params = make_weights(cfg, seed, "cpu", torch.float32, net)
    model = define_g({"network_G": net, "scale": 4}, device="cpu")
    model.load_state_dict(params, strict=True)
    return model, params


def _clip(t=5, h=64, w=64, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(1, t, h, w, 3, generator=g)


def test_state_dict_is_mmeditings_at_the_published_widths():
    """The keys and shapes of the published c64n7 model are the reference's
    list (mmediting's names), SPyNet's mean and std among them."""
    net = yaml.safe_load(open(YAML))["network_G"]
    model = define_g({"network_G": net, "scale": 4}, device="meta")
    want = {k: tuple(s) for k, s, _, _ in ref.param_specs(net)}
    want.update({k: tuple(v.shape) for k, v in ref.buffers("cpu").items()})
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == want
    assert got["deform_align.forward_2.conv_offset.0.weight"] == (64, 196,
                                                                 3, 3)
    assert got["deform_align.forward_2.weight"] == (64, 128, 3, 3)
    assert got["backbone.forward_2.main.0.weight"] == (64, 320, 3, 3)


def test_forward_matches_the_reference_per_frame():
    model, params = _model()
    x = _clip()
    with torch.no_grad():
        got = model(x)
        want, res = ref.forward(SMALL, params, x)
    assert got.shape == (1, 5, 256, 256, 3)
    for t in range(5):
        gap = (got[0, t] - want[0, t].permute(1, 2, 0)).pow(2).mean().sqrt()
        # f32 on both sides: rounding through the recurrence, far under
        # bf16's ~4e-3 a value
        assert gap < 1e-4 * res[0, t].pow(2).mean().sqrt(), t


def test_factored_step_matches_the_reference_per_frame():
    """Each branch step run as the graph runner runs it, its two segments
    and the DCN between them called apart (``align_input``, ``deform``,
    ``backbone_step`` into a buffer of its own): the whole clip equals
    ``forward`` and matches the plain reference as
    ``test_forward_matches_the_reference_per_frame`` holds it."""
    model, params = _model()
    x = _clip()
    calls = []

    def apart(module, prop, current, others, flow_n1=None, feat_n2=None,
              flow_prev=None):
        calls.append(feat_n2 is not None)
        if flow_n1 is None:
            return model.step(module, prop, current, others)
        xin, om = model.align_input(module, prop, current, flow_n1, feat_n2,
                                    flow_prev)
        aligned = model.deform_align[module].deform(xin, om)
        out = torch.empty_like(prop)
        got = model.backbone_step(module, current, others, aligned, out=out)
        assert got is out
        return out

    with torch.no_grad():
        whole = model(x)
        feats = {"spatial": model.extract(x)}
        fwd, bwd = model.compute_flow(x)
        for br in BRANCHES:
            model.propagate(feats, bwd if br.startswith("backward") else fwd,
                            br, apart)
        got = torch.stack([model.reconstruct(x[:, t], feats, t)
                           for t in range(5)], 1)
        want, res = ref.forward(SMALL, params, x)
    assert calls == 4 * [False, False, True, True, True]
    assert torch.equal(got, whole)
    for t in range(5):
        gap = (got[0, t] - want[0, t].permute(1, 2, 0)).pow(2).mean().sqrt()
        assert gap < 1e-4 * res[0, t].pow(2).mean().sqrt(), t


def test_cpu_restore_never_engages_the_graph_runner():
    """On the CPU every branch step runs eagerly: the model's runner
    captures nothing and ``restore.graph`` reads 0 for each of the clip's
    4 x T steps."""
    model, _ = _model()
    x = _clip(t=4)
    with profile(activities=[ProfilerActivity.CPU]):
        out = list(recurrent_infer(model, x[0].numpy(), "cpu"))
    assert len(out) == 4
    assert not graphs(model).sizes
    assert [c.value for c in trace.counters("restore.graph")] == [0] * 16


@pytest.mark.parametrize("differs", ["branch", "shape", "dtype", "device"])
def test_step_key_separates_branch_shape_and_dtype(differs):
    """The graphs' key is read from the step's input alone: (branch, B, H,
    W, C, dtype, device); a change of any one of them is another key, the
    same input the same key."""
    prop = torch.zeros(1, 18, 32, 16)
    other = {"branch": ("forward_1", prop),
             "shape": ("backward_1", torch.zeros(1, 18, 40, 16)),
             "dtype": ("backward_1", prop.to(torch.bfloat16)),
             "device": ("backward_1", torch.zeros(1, 18, 32, 16,
                                                  device="meta"))}[differs]
    key = step_key("backward_1", prop)
    assert key == ("backward_1", 1, 18, 32, 16, torch.float32,
                   torch.device("cpu"))
    assert step_key("backward_1", prop.clone()) == key
    assert step_key(*other) != key


def test_runner_drops_its_captures_once_the_weights_move():
    """The runner's captures read the branches' weights where they lay:
    a cast of the model (new tensors) drops them; an ask with the weights
    in place keeps them."""
    model, _ = _model()
    runner = graphs(model)
    size = (1, 64, 64, 16, torch.float32, torch.device("cpu"))
    runner.sizes[size] = (None, {})
    assert graphs(model) is runner and size in runner.sizes
    model.to(torch.float64)
    assert graphs(model) is runner and not runner.sizes


@pytest.mark.parametrize("half", ["first", "second"])
def test_alignment_offsets_carry_each_flow_to_its_half_of_the_groups(half):
    """Zero residues, a translation flow a half and a DCN weight that passes
    the centre tap: groups 0-7 (the first input, the previous output) are
    ``flow_warp`` by flow_1, groups 8-15 (the output two steps back) by
    flow_2.  This pins the (dy, dx) order and which groups each flow
    feeds."""
    mid = 16
    align = SecondOrderDeformableAlignment(2 * mid, mid, 16, 10)
    g = torch.Generator().manual_seed(5)
    reset_parameters(align, g)
    with torch.no_grad():
        last = align.conv_offset[6]
        last.weight.zero_()
        last.bias.zero_()
        last.bias[16 * 18:] = 30.0          # mask sigmoid(30) = 1 in f32
        align.weight.zero_()
        align.bias.zero_()
        for o in range(mid):
            align.weight[o, o + (0 if half == "first" else mid), 1, 1] = 1.0
    prop = torch.randn(1, 12, 14, mid, generator=g)
    n2 = torch.randn(1, 12, 14, mid, generator=g)
    cond = torch.randn(1, 12, 14, 3 * mid, generator=g)
    f1 = torch.tensor([2.25, -1.5]).expand(1, 12, 14, 2)      # (dx, dy)
    f2 = torch.tensor([-0.75, 3.5]).expand(1, 12, 14, 2)
    with torch.no_grad():
        got = align(torch.cat([prop, n2], -1), cond, f1, f2)
    want = flow_warp(prop, f1) if half == "first" else flow_warp(n2, f2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_recurrent_infer_yields_every_frame_once_in_order():
    model, _ = _model()
    x = _clip()
    with torch.no_grad():
        want = model(x)
    out = list(recurrent_infer(model, x[0].numpy(), "cpu"))
    assert [t for t, _ in out] == list(range(5))
    for t, frame in out:
        assert frame.dtype == np.float32 and frame.shape == (256, 256, 3)
        assert np.array_equal(frame, want[0, t].numpy()), t
    assert len({id(f) for _, f in out}) == 5


def test_restorer_runs_a_recurrent_model_over_whole_clips():
    model, _ = _model()
    x = _clip(t=4)
    args = argparse.Namespace(streaming=False, flip_test=False, tile=None,
                              overlap=0)
    restore = _cli.restorer(args, {"network_G": SMALL, "datasets": {
        "test": {}}}, model)
    with torch.no_grad():
        want = model(x)
    got = dict(restore(x[0].numpy()))
    assert sorted(got) == [0, 1, 2, 3]
    for t, frame in got.items():
        assert np.array_equal(frame, want[0, t].numpy())


@pytest.mark.parametrize("flag", ["flip_test", "tile", "streaming"])
def test_restorer_raises_for_window_options(flag):
    model, _ = _model()
    args = argparse.Namespace(streaming=flag == "streaming",
                              flip_test=flag == "flip_test",
                              tile=(32, 32) if flag == "tile" else None,
                              overlap=8)
    with pytest.raises(ValueError, match="recurrent"):
        _cli.restorer(args, {"network_G": SMALL, "datasets": {"test": {}}},
                      model)


def test_unsupported_settings_raise():
    with pytest.raises(NotImplementedError):
        define_g({"network_G": dict(SMALL, is_low_res_input=False),
                  "scale": 4}, device="cpu")
    with pytest.raises(ValueError, match="exact"):
        define_g({"network_G": SMALL, "scale": 4}, device="cpu",
                 dcn_max_offset=4.0)
    with pytest.raises(ValueError, match="x4"):
        define_g({"network_G": SMALL, "scale": 2}, device="cpu")


def test_restore_spans_and_branches():
    """Upload, extract and flow once a clip; one propagate span a branch in
    order, with its ``branch`` and req (clip, branch), holding that
    branch's kernel calls; a frame's upsample, wait and download with req
    (clip, frame); ``restore.ahead`` 0 for the first frame, 1 after."""
    model, _ = _model()
    x = _clip(t=4)
    with profile(activities=[ProfilerActivity.CPU]):
        out = list(recurrent_infer(model, x[0].numpy(), "cpu"))
    assert len(out) == 4
    (upload,) = trace.spans("restore.upload")
    clip = upload.req[0]
    for name in ("restore.extract", "restore.flow"):
        (s,) = trace.spans(name)
        assert s.req == (clip, 0) and s.attrs == {"frames": 4}
    props = sorted(trace.spans("restore.propagate"), key=lambda s: s.start_ns)
    assert [s.attrs["branch"] for s in props] == list(BRANCHES)
    assert [s.req for s in props] == [(clip, b) for b in BRANCHES]
    by_id = {s.id: s for s in props}
    convs = [k for k in trace.spans("kernel.conv3x3") if k.parent in by_id]
    # a branch's 3x3 convs on the kernel: at the first step its backbone's
    # input conv and block, at each later one the three offset convs after
    # the first too
    assert len(convs) == 4 * (3 + 3 * 6)
    assert all(k.req == by_id[k.parent].req for k in convs)
    for phase in ("upsample", "wait", "download"):
        got = sorted(trace.spans(f"restore.{phase}"),
                     key=lambda s: s.start_ns)
        assert [s.req for s in got] == [(clip, t) for t in range(4)], phase
    assert [c.value for c in trace.counters("restore.ahead")] == [0, 1, 1, 1]


def test_cli_restores_a_folder_from_the_yaml(tmp_path, monkeypatch):
    """``tools/test_wo_gt.py`` on the test YAML (shrunk to the small
    widths, on the CPU): every frame of a clip written at x4."""
    from realvsr_tpu_torch.core.config import parse
    from realvsr_tpu_torch.tools import test_wo_gt

    # results (the log, the frames) under tmp_path instead of the checkout
    monkeypatch.setattr(_cli, "parse", lambda path, is_train: parse(
        path, is_train=is_train, root=str(tmp_path)))

    opt = yaml.safe_load(open(YAML))
    opt["network_G"].update(mid_channels=16, num_blocks=1)
    lq = tmp_path / "LQ" / "clip0"
    lq.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for t in range(3):
        cv2.imwrite(str(lq / f"{t:08d}.png"),
                    rng.integers(0, 256, (64, 72, 3), dtype=np.uint8))
    opt["datasets"]["test"]["dataroot_LQ"] = str(tmp_path / "LQ")
    cfg = tmp_path / "cfg.yml"
    cfg.write_text(yaml.safe_dump(opt))
    got = test_wo_gt.main(["-opt", str(cfg), "--device", "cpu",
                           "--save_imgs"])
    assert got["n_frames"] == 3
    saved = sorted((tmp_path / "results" / opt["name"] / "clip0").iterdir())
    assert len(saved) == 3
    assert cv2.imread(str(saved[0])).shape == (256, 288, 3)
