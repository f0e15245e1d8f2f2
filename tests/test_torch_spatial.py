"""The port's H-sharded forward (``realvsr_tpu_torch/eval/spatial.py``) on
the CPU.

  * :func:`shard_forward` over 2 and 4 shards, concatenated, against the
    unsharded port forward of EDVRNoUp (nf 16, 1 + 1 ResBlocks, offsets
    randomised and clamped to ±4) on a 416-row frame, with the default
    halo (``receptive_field_rows(1, 1, 4)`` = 104 rows): within 1e-5 (the
    convolutions round differently on another shape).
  * :func:`spatial_sharded_forward` on two ``gloo`` processes against
    JAX's ``make_spatial_sharded_forward`` on a 2-device CPU mesh, the exact
    DCN and ``tests/test_spatial.py``'s halo of 68 rows at 288 x 48: both
    run each shard's window through the same model, so they agree to the
    5e-5 of ``test_torch_edvr.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from realvsr_tpu.eval.spatial import make_spatial_sharded_forward
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu.parallel.mesh import create_mesh
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.eval.spatial import default_halo, shard_forward
from realvsr_tpu_torch.eval.tiled import receptive_field_rows
from realvsr_tpu_torch.models.edvr import EDVRNoUp
from torch_jax_params import random_variables
from torch_parallel_worker import launch, wait

NET = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1, back_RBs=1,
           w_TSA=False)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(h, w):
    return random_variables(JaxEDVRNoUp(**NET), np.random.default_rng(0),
                            jnp.zeros((1, 3, h, w, 3)))["params"]


@pytest.fixture(scope="module")
def clamped():
    model = EDVRNoUp(**NET, dcn_max_offset=4, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(_params(32, 32)), strict=True)
    window = torch.from_numpy(np.random.default_rng(1).random(
        (1, 3, 416, 32, 3)).astype(np.float32))
    with torch.inference_mode():
        full = model(window)
    return model, window, full


@pytest.mark.parametrize("n_shard", [2, 4])
def test_shard_forward_matches_unsharded(clamped, n_shard):
    model, window, full = clamped
    halo = default_halo(model)
    assert halo == receptive_field_rows(1, 1, 4) == 104
    with torch.inference_mode():
        parts = [shard_forward(model, window, i, n_shard, halo)
                 for i in range(n_shard)]
    out = torch.cat(parts, 1)
    assert out.shape == full.shape
    torch.testing.assert_close(out, full, atol=1e-5, rtol=0)


def test_shard_forward_checks_as_jax(clamped):
    model, window, _ = clamped
    with pytest.raises(AssertionError, match="too short"):
        shard_forward(model, window, 0, 2, 108)
    with pytest.raises(AssertionError, match="pyramid phase"):
        shard_forward(model, window, 0, 2, 66)
    with pytest.raises(ValueError, match="unbounded"):
        default_halo(EDVRNoUp(**NET, device="cpu"))
    # the flagship's default: 128 rows, an 800-row window of 1088 in two
    assert receptive_field_rows(5, 10, 4) == 128


def test_two_process_sharded_forward_matches_jax(tmp_path):
    params = _params(288, 48)
    window = np.random.default_rng(0).uniform(
        size=(1, 3, 288, 48, 3)).astype(np.float32)
    torch.save({"G": state_dict_from_jax(params)}, tmp_path / "init.pt")
    np.savez(tmp_path / "window.npz", window=window)
    opt = {"network_G": dict(NET, which_model_G="EDVR_NoUp",
                             predeblur=False, HR_in=False), "scale": 1}
    procs = launch(tmp_path, "spatial", dict(
        opt=opt, init=str(tmp_path / "init.pt"), halo=68,
        batch=str(tmp_path / "window.npz"), out=str(tmp_path / "sp")))
    jmodel = JaxEDVRNoUp(**NET)
    mesh = create_mesh(data_axis=1, model_axis=2, devices=jax.devices()[:2])
    fwd = make_spatial_sharded_forward(jmodel, params, mesh, halo=68)
    ref = np.asarray(fwd(params, jnp.asarray(window)))
    wait(procs)
    outs = [torch.load(tmp_path / f"sp.{r}.pt") for r in range(2)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].shape == ref.shape == (1, 288, 48, 3)
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=5e-5, rtol=0)
