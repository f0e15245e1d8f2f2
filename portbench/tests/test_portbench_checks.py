"""The check that decides ``correct``, driven through a whole run on the CPU
at a small size (the harness's look for a card is skipped): the program
passes each cell's limits, and the control and each fault the cell can have
fails them.

* restore cells: the control (the reference in fp8, below the cells' bf16)
  and an answer altered where it is produced (each restored frame replaced
  by the one before it: an off-by-one window);
* the training cell: the control (the program's own bf16 path in the
  float32 cell's place), a step that returns its state unchanged, and half
  of each batch left out with the mean taken over the rest.

The cells run on one card, so no exchange between cards can be left out.
"""
import contextlib
import time

import pytest
import torch

from portbench import harness

RESTORE = ["edvr_noup.restore_clips", "edvr_l.restore_clips"]
TRAIN = "edvr_noup.train_split"


def _small_restore(name):
    cell = harness.load_cell(name)
    cell.config["network_G"].update(nf=16, front_RBs=1, back_RBs=1)
    cell.config["restore_size"] = [32, 48]
    cell.traffic.update(clips=2, frames_per_clip=6, warmup_frames=1)
    return cell


def _small_train():
    cell = harness.load_cell(TRAIN)
    cell.config["network_G"].update(nf=16, front_RBs=1, back_RBs=1)
    cell.traffic.update(batch_size=4, crop=48, pool_samples=16, n_workers=1,
                        reference_block=2)
    return cell


def _run(cell, seed, controls=False):
    return harness.run_cell(cell, seed, 1.0, False, torch.device("cpu"),
                            time.perf_counter(), controls)


@contextlib.contextmanager
def _patched(owner, attr, make):
    orig = getattr(owner, attr)
    setattr(owner, attr, make(orig))
    try:
        yield
    finally:
        setattr(owner, attr, orig)


@pytest.mark.parametrize("name", RESTORE)
def test_restore_program_passes_and_control_fails(name):
    line = _run(_small_restore(name), 2 ** 31 + 5, controls=True)
    assert line["correct"], line["checks"]
    assert line["fp8_frame_gap"] > line["checks"]["frame_gap"]["limit"]


@pytest.mark.parametrize("name", RESTORE)
def test_restore_altered_answer_fails(name):
    from realvsr_tpu_torch.tools import _cli

    def stale(restorer):
        def make(args, opt, model):
            inner = restorer(args, opt, model)

            def restore(frames):
                prev = None
                for idx, out in inner(frames):
                    yield idx, out if prev is None else prev
                    prev = out
            return restore
        return make

    with _patched(_cli, "restorer", stale):
        line = _run(_small_restore(name), 11)
    assert not line["correct"], line["checks"]


def test_train_program_passes_and_half_batch_fails():
    line = _run(_small_train(), 2 ** 31 + 9, controls=True)
    assert line["correct"], line["checks"]
    lim = {k: c["limit"] for k, c in line["checks"].items()}
    assert any(line["half_batch"][k] > v for k, v in lim.items())


def test_train_control_fails():
    """The control of the float32 cell: the program's own bf16 path
    (``mixed_precision``) in its place."""
    cell = _small_train()
    cell.traffic["dtype"] = "bfloat16"
    line = _run(cell, 2 ** 31 + 9)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_faults_fail(fault):
    from realvsr_tpu_torch.train import trainer as tmod

    def broken(make_train_step):
        def make(model, opt, feature_apply=None):
            inner = make_train_step(model, opt, feature_apply)

            def step(state, batch, gen):
                if fault == "unchanged":
                    with torch.no_grad():
                        saved = [p.clone() for p in state.model.parameters()]
                    state, logs = inner(state, batch, gen)
                    with torch.no_grad():
                        for p, s in zip(state.model.parameters(), saved):
                            p.copy_(s)
                    return state, logs
                half = batch["LQs"].shape[0] // 2
                return inner(state, {k: v[:half] for k, v in batch.items()},
                             gen)
            return step
        return make

    with _patched(tmod, "make_train_step", broken):
        line = _run(_small_train(), 13)
    assert not line["correct"], line["checks"]
