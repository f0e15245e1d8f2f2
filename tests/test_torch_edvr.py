"""EDVR_NoUp: the port vs the JAX package on the CPU, same weights, f32.

The JAX params come from ``model.init`` with the zero-initialised DCN offset
convs randomised (numpy seed) so the offsets reach a few pixels and the
fractional sampling is exercised; they move to the port through
``state_dict_from_jax``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models.common import set_conv3x3_impl
from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu.ops import deform_conv as jdc
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.models.edvr import EDVRNoUp

CFG = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1, back_RBs=1,
           w_TSA=False)
R = 4  # the deployment clamp of bench.py


def _randomise_offset_convs(params, rng, scale=1.5):
    """scale 1.5 gives offsets of ~1.2 px mean, ~5 px max at this size."""
    for lvl in ("L3", "L2", "L1", "cas"):
        c = params["pcd_align"][f"{lvl}_dcnpack"]["conv_offset_mask"]["Conv_0"]
        for name in ("kernel", "bias"):
            c[name] = (rng.normal(size=c[name].shape) * scale).astype(
                np.float32)
    return params


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    x = rng.random((1, 3, 32, 64, 3)).astype(np.float32)
    jmodel = JaxEDVRNoUp(**CFG)
    params = jax.tree.map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    params = _randomise_offset_convs(params, rng)
    tmodel = EDVRNoUp(**CFG, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return x, jmodel, params, tmodel


def _torch_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def test_edvr_matches_jax_xla(models):
    x, jmodel, params, tmodel = models
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    ours = _torch_out(tmodel, x)
    assert ours.shape == ref.shape == (1, 32, 64, 3)
    np.testing.assert_allclose(ours, ref, atol=5e-5)
    # the randomised offsets matter: zeroing them moves the output
    flat = EDVRNoUp(**CFG, device="cpu").eval()
    sd = {k: (torch.zeros_like(v) if "conv_offset_mask" in k else v)
          for k, v in tmodel.state_dict().items()}
    flat.load_state_dict(sd)
    assert np.abs(_torch_out(flat, x) - ours).max() > 1e-3


def test_edvr_matches_jax_pallas_kernels_interpret(models):
    """JAX through both Pallas kernels of the main path (interpret mode) at
    the ±R clamp vs the port at ``dcn_max_offset=R``.  The frame kernel's
    int16 positions bound the error (8e-3, as tests/test_deform_conv.py
    holds that kernel)."""
    x, jmodel, params, _ = models
    tmodel = EDVRNoUp(**CFG, dcn_max_offset=R, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    set_conv3x3_impl("pallas_interpret")
    prev = jdc.set_default_impl("frame", block_max_offset=R,
                                pallas_interpret=True)
    try:
        ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    finally:
        set_conv3x3_impl("xla")
        jdc.set_default_impl(*prev, pallas_interpret=False)
    np.testing.assert_allclose(_torch_out(tmodel, x), ref, atol=8e-3)


def test_pyramid_and_fuse_modes_equal_full(models):
    x, _, _, tmodel = models
    xt = torch.from_numpy(x)
    b, n, h, w, c = xt.shape
    with torch.inference_mode():
        full = tmodel(xt)
        l1, l2, l3 = tmodel(xt.reshape(b * n, h, w, c), mode="pyramid")
        stack = [t.reshape(b, n, *t.shape[1:]) for t in (l1, l2, l3)]
        fused = tmodel((*stack, xt[:, tmodel.center_idx]), mode="fuse")
    torch.testing.assert_close(fused, full, rtol=0, atol=0)
    assert l2.shape == (3, 16, 32, 16) and l3.shape == (3, 8, 16, 16)


_NETS = {
    "EDVR_NoUp": dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1,
                      back_RBs=1, center=None, predeblur=False, HR_in=False,
                      w_TSA=False),
    "EDVR": dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=1, back_RBs=1,
                 center=None, predeblur=False, HR_in=False, w_TSA=True),
    "TDAN": dict(nf=64, nc=3, nframes=3, nb_f=1, nb_b=1, groups=8),
    "TOF": dict(nf=16, nc=3, nframes=3, K=3, nb=1),
    "FSTRN": dict(k=3, nf=8, nframes=3),
    "RCAN": dict(num_in_ch=3, num_out_ch=3, num_frames=3, num_feat=16,
                 num_group=1, num_block=1, squeeze_factor=4, res_scale=1),
}


@pytest.mark.parametrize("which", ["EDVR_NoUp", "EDVR", "TDAN", "TOF",
                                   "FSTRN", "RCAN"])
def test_define_g_builds_edvr_noup_and_names_unported_models(which):
    """Every generator of the JAX factory builds from its YAML keys, the
    same weights from the same seed (TOF, FSTRN and RCAN since ROADMAP
    queue 1, item 5 was ported; the factory raised for them before)."""
    opt = {"scale": 1, "network_G": dict(_NETS[which], which_model_G=which)}
    a = define_g(opt, device="cpu", generator=torch.Generator().manual_seed(3))
    b = define_g(opt, device="cpu",
                 generator=torch.Generator().manual_seed(3))
    assert type(a).__name__ == which.replace("_", "")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)


def test_init_matches_jax_init_statistics():
    """The port's initialisers follow the JAX package's torch-semantics ones:
    same bounds / scales per parameter kind, zero DCN offset convs."""
    m = EDVRNoUp(**CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    sd = m.state_dict()
    assert not sd["pcd_align.L1_dcnpack.conv_offset_mask.weight"].any()
    assert not sd["recon_trunk.0.conv1.bias"].any()
    bound = 1 / np.sqrt(3 * 9)
    w = sd["conv_first.weight"]
    assert w.abs().max() <= bound and w.abs().max() > 0.8 * bound
    std = sd["feature_extraction.0.conv1.weight"].std().item()
    assert 0.5 * 0.1 * np.sqrt(2 / 144) < std < 1.5 * 0.1 * np.sqrt(2 / 144)
    assert sd["tsa_fusion.weight"].shape == (16, 48, 1, 1)
