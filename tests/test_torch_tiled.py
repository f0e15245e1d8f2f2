"""Tiled inference (``realvsr_tpu_torch/eval/tiled.py``) against the JAX
package's ``tiled_forward`` on the CPU in f32, and the port's tilers
against each other and against the full-frame forward.

EDVR_NoUp at nf 16, 4 deformable groups, 2 + 2 ResBlocks on a 3 x 72 x 104
window in 48 x 64 tiles with 16 pixels of overlap (9 tiles, clamped edge
tiles on both axes), and EDVR x4 at 2 + 2 ResBlocks for the scaled
stitch; weights from the JAX ``model.init`` through
``state_dict_from_jax``.  Tolerances: 1e-4 against JAX (f32 sums in other
orders), 1e-5 between the port's two tilers (the same tiles at another
batch).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.eval import tiled as jtiled
from realvsr_tpu.eval.spatial import receptive_field_rows as jax_rf_rows
from realvsr_tpu.models.edvr import EDVR as JaxEDVR
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.eval import tiled
from realvsr_tpu_torch.models.edvr import EDVR, EDVRNoUp

CFG = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=2, back_RBs=2,
           w_TSA=False)
TILE, OVERLAP = (48, 64), 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jcls, tcls, seed):
    jmodel = jcls(**CFG)
    params = jax.tree.map(np.asarray, jax.device_get(jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 16, 16, 3)))["params"]))
    tmodel = tcls(**CFG, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def noup():
    x = np.random.default_rng(0).random((3, 72, 104, 3)).astype(np.float32)
    jmodel, params, tmodel = _pair(JaxEDVRNoUp, EDVRNoUp, 0)

    @jax.jit
    def fwd(tile):
        return jmodel.apply({"params": params}, tile[None])[0]

    ref = np.asarray(jtiled.tiled_forward(fwd, jnp.asarray(x), TILE,
                                          OVERLAP), np.float32)
    return x, tmodel, ref


def test_tile_grid_clamps_edge_tiles():
    (th, tw), tiles = tiled.tile_grid(72, 104, TILE, OVERLAP)
    assert (th, tw) == TILE
    assert [t[:2] for t in tiles] == [(y, x) for y in (0, 16, 24)
                                      for x in (0, 32, 40)]
    # the valid centres cover the frame
    cover = np.zeros((72, 104), int)
    for _, _, (vy0, vy1, vx0, vx1) in tiles:
        cover[vy0:vy1, vx0:vx1] += 1
    assert (cover >= 1).all()


def test_loop_tiler_matches_jax(noup):
    x, tmodel, ref = noup
    out = tiled.make_tiled_forward(tmodel, tile_hw=TILE, overlap=OVERLAP,
                                   device="cpu")(x)
    assert out.shape == (72, 104, 3) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_batched_tiler_matches_jax_and_the_loop_tiler(noup):
    x, tmodel, ref = noup
    batched = tiled.make_batched_tiled_forward(
        tmodel, tile_hw=TILE, overlap=OVERLAP, device="cpu")(x)
    np.testing.assert_allclose(batched.numpy(), ref, atol=1e-4)

    @torch.inference_mode()
    def fwd(tile):
        return tmodel(tile[None])[0]

    loop = tiled.tiled_forward(fwd, torch.from_numpy(x), TILE, OVERLAP)
    np.testing.assert_allclose(batched.numpy(), loop.numpy(), atol=1e-5)


def test_tiled_matches_full_frame_away_from_seams(noup):
    """At init the DCN offsets are 0 (zero-initialised offset convs), so
    the model is local and the 16-pixel overlap covers most of its reach:
    the JAX package's own check (``tests/test_tiled.py``) on the port."""
    x, tmodel, _ = noup
    out = tiled.make_batched_tiled_forward(
        tmodel, tile_hw=TILE, overlap=OVERLAP, device="cpu")(x)
    with torch.inference_mode():
        full = tmodel(torch.from_numpy(x)[None])[0]
    diff = (out - full).abs().numpy()[8:-8, 8:-8]
    assert diff.max() < 2e-2, diff.max()
    assert np.mean(diff < 1e-5) > 0.85


def test_scaled_tiles_match_jax():
    jmodel, params, tmodel = _pair(JaxEDVR, EDVR, 1)
    x = np.random.default_rng(1).random((3, 32, 48, 3)).astype(np.float32)

    @jax.jit
    def fwd(tile):
        return jmodel.apply({"params": params}, tile[None])[0]

    ref = np.asarray(jtiled.tiled_forward(fwd, jnp.asarray(x), (24, 32), 4,
                                          scale=4), np.float32)
    out = tiled.make_batched_tiled_forward(tmodel, tile_hw=(24, 32),
                                           overlap=4, scale=4,
                                           device="cpu")(x)
    assert out.shape == (128, 192, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("args", [(5, 10, 4), (1, 1, 4), (2, 2, 8),
                                  (5, 10, 0)])
def test_receptive_field_rows_is_the_jax_one(args):
    assert tiled.receptive_field_rows(*args) == jax_rf_rows(*args)
    assert tiled.receptive_field_rows(5, 10, 4) == 128


def test_sequence_restorer_tiles_each_window(noup):
    """The test CLIs' ``--tile H W --overlap P``: each sliding window
    restored by the batched tiler."""
    from realvsr_tpu_torch.tools._cli import parse_args, restorer
    from realvsr_tpu_torch.utils.indexing import index_generation

    x, tmodel, _ = noup
    frames = np.concatenate([x, x[:1]])  # 4 frames
    args = parse_args(["-opt", "test.yml", "--tile", *map(str, TILE),
                       "--overlap", str(OVERLAP)], "")
    restore = restorer(args, {"datasets": {"test": {}},
                              "network_G": {"nframes": 3}}, tmodel)
    batched = tiled.make_batched_tiled_forward(
        tmodel, tile_hw=TILE, overlap=OVERLAP, device="cpu")
    for idx, out in restore(frames):
        window = frames[index_generation(idx, 4, 3, "replicate")]
        np.testing.assert_allclose(out, batched(window).numpy(), atol=1e-6)
