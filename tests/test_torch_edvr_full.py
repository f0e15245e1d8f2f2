"""The rest of the EDVR family: the port vs the JAX package on the CPU, same
weights, f32 — EDVR x4 with TSA, EDVR_NoUp with TSA, the pre-deblur front
end and the HR_in front end, at nf 16 and cut depth.

The JAX params come from ``model.init`` with the zero-initialised DCN offset
convs randomised (numpy seed); they move to the port through
``state_dict_from_jax`` with a strict load.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models import edvr as jedvr
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models import define_g
from realvsr_tpu_torch.models.edvr import EDVR, EDVRNoUp

BASE = dict(nf=16, nc=3, nframes=5, groups=4, front_RBs=1, back_RBs=1)
CASES = {  # name: (class name, options, input H, W)
    "x4_tsa": ("EDVR", dict(w_TSA=True), 32, 64),
    "noup_tsa": ("EDVRNoUp", dict(w_TSA=True), 32, 64),
    "x4_predeblur_tsa": ("EDVR", dict(w_TSA=True, predeblur=True), 32, 64),
    "noup_predeblur": ("EDVRNoUp", dict(predeblur=True, w_TSA=False),
                       32, 64),
    "x4_hr_in": ("EDVR", dict(HR_in=True, w_TSA=False), 128, 128),
}
PORT = {"EDVR": EDVR, "EDVRNoUp": EDVRNoUp}


def _randomise_offset_convs(params, rng, scale=1.5):
    for lvl in ("L3", "L2", "L1", "cas"):
        c = params["pcd_align"][f"{lvl}_dcnpack"]["conv_offset_mask"]["Conv_0"]
        for name in ("kernel", "bias"):
            c[name] = (rng.normal(size=c[name].shape) * scale).astype(
                np.float32)
    return params


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cls, opts, h, w = CASES[request.param]
    cfg = dict(BASE, **opts)
    rng = np.random.default_rng(0)
    x = rng.random((1, 5, h, w, 3)).astype(np.float32)
    jmodel = getattr(jedvr, cls)(**cfg)
    params = jax.tree.map(np.asarray, jax.device_get(
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))
    params = _randomise_offset_convs(params, rng)
    tmodel = PORT[cls](**cfg, device="cpu").eval()
    tmodel.load_state_dict(state_dict_from_jax(params), strict=True)
    return x, jmodel, params, tmodel, cls, opts


def _torch_out(model, x):
    with torch.inference_mode():
        return model(torch.from_numpy(x)).numpy()


def test_matches_jax(case):
    x, jmodel, params, tmodel, cls, opts = case
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x)))
    ours = _torch_out(tmodel, x)
    scale = 4 if cls == "EDVR" and not opts.get("HR_in") else 1
    assert ours.shape == ref.shape == (1, x.shape[2] * scale,
                                       x.shape[3] * scale, 3)
    np.testing.assert_allclose(ours, ref, atol=5e-5)


def test_pyramid_and_fuse_modes_equal_full(case):
    x, _, _, tmodel, _, _ = case
    xt = torch.from_numpy(x)
    b, n, h, w, c = xt.shape
    with torch.inference_mode():
        full = tmodel(xt)
        pyr = tmodel(xt.reshape(b * n, h, w, c), mode="pyramid")
        stack = [t.reshape(b, n, *t.shape[1:]) for t in pyr]
        fused = tmodel((*stack, xt[:, tmodel.center_idx]), mode="fuse")
    torch.testing.assert_close(fused, full, rtol=0, atol=0)


def test_state_dict_keys():
    """The reference keys of TSA and the pre-deblur front end, each as the
    JAX export names them."""
    m = EDVR(**BASE, w_TSA=True, predeblur=True, device="cpu")
    sd = m.state_dict()
    for key, shape in (("tsa_fusion.sAtt_L2.weight", (16, 32, 3, 3)),
                       ("tsa_fusion.fea_fusion.weight", (16, 80, 1, 1)),
                       ("pre_deblur.RB_L1_1.conv1.weight", (16, 16, 3, 3)),
                       ("conv_1x1.weight", (16, 16, 1, 1)),
                       ("upconv1.weight", (64, 16, 3, 3)),
                       ("upconv2.weight", (256, 16, 3, 3)),
                       ("conv_last.weight", (3, 64, 3, 3))):
        assert tuple(sd[key].shape) == shape, key
    assert "conv_first.weight" not in sd
    with pytest.raises(ValueError, match="HR_in"):
        EDVRNoUp(**BASE, HR_in=True, device="cpu")


def test_define_g_builds_edvr_x4_from_the_vimeo_recipe_keys():
    opt = {"scale": 4, "network_G": dict(
        which_model_G="EDVR", nf=16, nc=3, nframes=7, groups=4, front_RBs=1,
        back_RBs=1, predeblur=False, HR_in=False, w_TSA=True)}
    a = define_g(opt, device="cpu", generator=torch.Generator().manual_seed(2))
    b = define_g(opt, device="cpu", generator=torch.Generator().manual_seed(2))
    assert isinstance(a, EDVR) and a.center_idx == 3
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    with torch.inference_mode():
        y = a(torch.rand(1, 7, 16, 16, 3))
    assert y.shape == (1, 64, 64, 3) and torch.isfinite(y).all()
