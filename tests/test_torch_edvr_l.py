"""EDVR-L's width in the port against the JAX package on the CPU: EDVR x4 +
TSA at nf 128 in 8 deformable groups (the EDVR release's large model,
``EDVR_Vimeo90K_SR_L``: 5 + 40 ResBlocks, 7 frames) cut to 1 + 1 ResBlocks
and 5 frames, LQ 16x16, f32.

* the forward on a motion-synthetic window, within 1e-4 of the output's
  largest magnitude;
* one Split step (loss, every gradient, every parameter after Adam) as
  ``test_torch_train_families.py::hold_split_step`` holds TDAN's and EDVR
  x4 + TSA's: each gradient within 1e-4 of its largest (5e-4 on the DCN
  offset chains), plus how far the JAX package's own step moves it when
  its DCN runs the tap loop in place of the columns (the same exact
  function, summed in another order).

JAX's variables come from ``tests/torch_jax_params.random_variables``
(``jax.eval_shape`` and numpy: no compiled init) and move to the port
through ``state_dict_from_jax`` with a strict load.  The DCN offset convs
are redrawn with std 0.5 / sqrt(8): the nf 16 family's 0.5 at the 8x
fan-in of nf 128, so the offsets reach the same few pixels.  With these
random weights the offset chains' gradients pass the exact DCN's position
derivative, which jumps where a sample crosses a pixel, and TSA's max
pools: f32 rounding alone moves them beyond 1e-4, as the JAX package's two
exact DCN implementations show against each other (the spread added
above).  The card runs it too (``tests/test_torch_cuda.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models import define_g as jax_define_g
from realvsr_tpu.ops import deform_conv as jdc
from test_torch_train_families import (_batch, _jax_steps, _opt, _port,
                                       _randomise_offset_convs,
                                       hold_split_step)
from torch_jax_params import random_variables

NAME = "edvr_l"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def edvr_l():
    """(name, JAX model, params, batch, the JAX exact step's (losses,
    grads, params after)) as ``setup_family`` gives them, and the same
    step through JAX's tap-loop DCN."""
    batch = _batch(NAME)
    opt = _opt(NAME)
    jmodel = jax_define_g(opt)
    params = random_variables(jmodel, np.random.default_rng(0),
                              jnp.asarray(batch["LQs"]))["params"]
    _randomise_offset_convs(params, np.random.default_rng(1),
                            std=0.5 / 8 ** 0.5)
    exact = _jax_steps(opt, jmodel, params, batch, 1)
    prev = jdc.set_default_impl("tap_loop")
    try:
        tap_loop = _jax_steps(opt, jmodel, params, batch, 1)
    finally:
        jdc.set_default_impl(*prev)
    return (NAME, jmodel, params, batch, exact), tap_loop


def test_edvr_l_forward_matches_jax(edvr_l):
    _, jmodel, params, batch, _ = edvr_l[0]
    opt = _opt(NAME)
    assert (opt["network_G"]["nf"], opt["network_G"]["groups"]) == (128, 8)
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                           jnp.asarray(batch["LQs"])))
    model, _ = _port(opt, params, None)
    with torch.inference_mode():
        ours = model(torch.from_numpy(batch["LQs"])).numpy()
    assert ours.shape == ref.shape == (2, 64, 64, 3)
    np.testing.assert_allclose(ours, ref,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))


def test_edvr_l_split_step_matches_jax(edvr_l):
    family, tap_loop = edvr_l
    hold_split_step(family, "exact", alt=tap_loop)
