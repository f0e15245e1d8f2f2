"""TDAN: the port vs the JAX package on the CPU, same weights, f32.

The JAX params come from ``model.init`` with the zero-initialised DCN offset
convs randomised (numpy seed) so the offsets reach a few pixels; they move
to the port through ``state_dict_from_jax`` with a strict load.  TDAN runs
only at nf 64 (the reference's ResBlocks are 64 wide whatever nf is), so
the width is full and the depth cut.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models.tdan import TDAN as JaxTDAN
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.models.tdan import TDAN

CFG = dict(channel=3, nframes=3, nf=64, nb_f=2, nb_b=2, groups=4)
DCNS = ("deform_conv_1", "deform_conv_2", "deform_conv_3", "deform_conv")
R = 4  # the deployment clamp of bench.py


def _randomise_offset_convs(params, rng, scale=1.0):
    """Offsets of 1-2 px mean at this size; the first DCN's reach ~10 px,
    beyond the ±4 clamp."""
    for name in DCNS:
        c = params["align"][name]["conv_offset_mask"]["Conv_0"]
        for leaf in ("kernel", "bias"):
            c[leaf] = (rng.normal(size=c[leaf].shape) * scale).astype(
                np.float32)
    return params


@pytest.fixture(scope="module", params=[1, 4], ids=["x1", "x4"])
def models(request):
    scale = request.param
    rng = np.random.default_rng(0)
    x = rng.random((1, 3, 16, 32, 3)).astype(np.float32)
    jmodel = JaxTDAN(**CFG, scale=scale)
    params = jax.tree.map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    params = _randomise_offset_convs(params, rng)
    return x, jmodel, params, scale


def _port(params, scale, r=None):
    m = TDAN(**CFG, scale=scale, dcn_max_offset=r, device="cpu").eval()
    m.load_state_dict(state_dict_from_jax(params), strict=True)
    return m


def _torch_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def test_tdan_matches_jax_exact_dcn(models):
    x, jmodel, params, scale = models
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    tmodel = _port(params, scale)
    ours = _torch_out(tmodel, x)
    assert ours.shape == ref.shape == (1, 16 * scale, 32 * scale, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    # the randomised offsets matter: zeroing them moves the output
    sd = {k: (torch.zeros_like(v) if "conv_offset_mask" in k else v)
          for k, v in tmodel.state_dict().items()}
    tmodel.load_state_dict(sd)
    assert np.abs(_torch_out(tmodel, x) - ours).max() > 1e-3


def test_tdan_matches_jax_block_dcn(models):
    """JAX through its ±R block DCN (XLA) vs the port at dcn_max_offset=R;
    some offsets lie beyond R, so the clamp is in play (the outputs are
    ~0.05 at init, so its effect is small but well above f32 rounding)."""
    x, jmodel, params, scale = models
    prev = jdc.set_default_impl("block", block_max_offset=R)
    try:
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    finally:
        jdc.set_default_impl(*prev)
    ours = _torch_out(_port(params, scale, R), x)
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    exact = _torch_out(_port(params, scale), x)
    assert np.abs(exact - ours).max() > 2e-5


def test_tdan_state_dict_keys_and_define_g():
    """The reference keys (no bias on final_conv); define_g builds TDAN from
    the recipe's keys with scale from the top of the config, seeded."""
    opt = {"scale": 1, "network_G": dict(which_model_G="TDAN", nf=64, nc=3,
                                         nframes=3, nb_f=1, nb_b=1,
                                         groups=8)}
    a = define_g(opt, device="cpu", generator=torch.Generator().manual_seed(1))
    b = define_g(opt, device="cpu", generator=torch.Generator().manual_seed(1))
    assert isinstance(a, TDAN)
    sd = a.state_dict()
    assert "trunk.final_conv.weight" in sd
    assert "trunk.final_conv.bias" not in sd
    assert sd["align.deform_conv_1.conv_offset_mask.weight"].shape == \
        (8 * 27, 64, 3, 3)
    assert sd["align.bottle_neck.weight"].shape == (64, 128, 3, 3)
    assert sd["trunk.feature_extractor.weight"].shape == (64, 9, 3, 3)
    assert not any(k.startswith("trunk.upsampler") for k in sd)
    for (ka, va), (kb, vb) in zip(sd.items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
