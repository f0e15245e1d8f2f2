"""The generators that train beside EDVR and TDAN (``realvsr_tpu_torch/
models/{srresnet,tof,fstrn,rcan}.py``) and ``ops/warp.py``, against the
JAX package on the CPU in f32: forwards from the same seeded random
variables (``torch_jax_params``, carried over with ``state_dict_from_jax``
and loaded with ``strict=True``), TOF's SpyNet BatchNorms in train mode
(with the running statistics JAX's mutable apply writes) and in eval mode.

Tolerances: 1e-5 of the output's largest magnitude for the warp and the
resizes; 1e-4 for the models (f32 convs through ~10-30 layers summed in
other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models.fstrn import FSTRN as JaxFSTRN
from realvsr_tpu.models.rcan import RCAN as JaxRCAN
from realvsr_tpu.models.srresnet import MSRResNet as JaxMSRResNet
from realvsr_tpu.models.tof import TOF as JaxTOF
from realvsr_tpu.ops.warp import flow_warp as jax_flow_warp
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.models.common import updating_batch_stats
from realvsr_tpu_torch.models.fstrn import FSTRN
from realvsr_tpu_torch.models.rcan import RCAN
from realvsr_tpu_torch.models.srresnet import MSRResNet
from realvsr_tpu_torch.models.tof import TOF
from realvsr_tpu_torch.ops.warp import flow_warp
from torch_jax_params import random_variables


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch intra-op thread: the suite runs files in parallel workers,
    where each worker's full thread pool would fight the others for the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(out, ref, rel):
    ref = torch.from_numpy(np.array(ref, np.float32))
    assert out.shape == ref.shape
    torch.testing.assert_close(out.detach().float(), ref, rtol=0,
                               atol=rel * ref.abs().max().item())


@pytest.mark.parametrize("padding", ["zeros", "border"])
@pytest.mark.parametrize("hw", [(6, 9), (1, 7), (5, 1)],
                         ids=["6x9", "h1", "w1"])
def test_flow_warp_matches_jax(padding, hw):
    """Flows of a few pixels, many past the edges (std 3 on a 6x9 image),
    integer positions included; one-pixel sides (where an align_corners
    =True normalisation divides by zero); the output and both inputs'
    gradients."""
    rng = np.random.default_rng(0)
    h, w = hw
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    flow = (rng.normal(size=(2, h, w, 2)) * 3).astype(np.float32)
    flow[0, 0, 0] = (1.0, -1.0)                 # an integer position
    gout = rng.normal(size=(2, h, w, 3)).astype(np.float32)

    def f(x, flow):
        return jnp.sum(jax_flow_warp(x, flow, padding) * gout)

    ref = jax.jit(lambda a, b: jax_flow_warp(a, b, padding))(x, flow)
    gx, gflow = jax.jit(jax.grad(f, argnums=(0, 1)))(x, flow)
    xt = torch.from_numpy(x).requires_grad_(True)
    ft = torch.from_numpy(flow).requires_grad_(True)
    out = flow_warp(xt, ft, padding)
    _close(out, ref, 1e-5)
    (out * torch.from_numpy(gout)).sum().backward()
    _close(xt.grad, gx, 1e-5)
    _close(ft.grad, gflow, 1e-4)


def _jax_forward(jmodel, variables, x, train=False):
    """JAX's forward; with ``train`` its mutable train-mode apply and the
    eval apply on the statistics that one writes, in one compile: (out,
    batch_stats written, eval out)."""
    def fwd(v, x):
        if train:
            out, mut = jmodel.apply(v, x, train=True,
                                    mutable=["batch_stats"])
            stats = mut["batch_stats"]
            return out, stats, jmodel.apply(
                {"params": v["params"], "batch_stats": stats}, x)
        return jmodel.apply(v, x), {}, None

    return jax.jit(fwd)(variables, jnp.asarray(x))


def _port(model, variables):
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("scale,nc", [(1, 9), (4, 3)], ids=["x1", "x4"])
def test_msrresnet_matches_jax(scale, nc):
    """x1 on 9 channels (3 frames: the base is the centre frame's 3) and x4
    on 3 (two pixel shuffles and the bilinear base)."""
    rng = np.random.default_rng(1)
    x = rng.random((2, 12, 12, nc), np.float32)
    jmodel = JaxMSRResNet(in_nc=nc, nf=16, nb=2, upscale=scale)
    variables = random_variables(jmodel, rng, jnp.asarray(x))
    model = _port(MSRResNet(nc, 3, 16, 2, scale, device="cpu"), variables)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)),
               _jax_forward(jmodel, variables, x)[0], 1e-4)


def test_tof_matches_jax_with_spynet_bn_in_train_and_eval():
    """TOF (K = 3 SpyNet levels, so 16x16 frames go down to 2x2): train
    mode normalises SpyNet's BNs with each neighbour's batch statistics and
    moves the running ones twice (one SpyNet call a neighbour), as JAX's
    mutable apply; eval mode reads them."""
    rng = np.random.default_rng(2)
    x = rng.random((2, 3, 16, 16, 3), np.float32)
    jmodel = JaxTOF(nframes=3, K=3, nf=16, nb=1, upscale=1)
    variables = random_variables(jmodel, rng, jnp.asarray(x))
    model = _port(TOF(3, 3, 3, 3, 16, 1, 1, device="cpu"), variables)
    model.train()
    with updating_batch_stats(model):
        out = model(torch.from_numpy(x))
    ref, stats, ref_eval = _jax_forward(jmodel, variables, x, train=True)
    _close(out, ref, 1e-4)
    written = state_dict_from_jax({"params": {}, "batch_stats": stats})
    sd = model.state_dict()
    assert len(written) == 2 * 4 * 4   # mean and var of 4 BNs x 4 blocks
    for k, v in written.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{k}: {m}")
        assert sd[k.replace("running_mean", "num_batches_tracked")
                  .replace("running_var", "num_batches_tracked")] == 2
    model.eval()
    with torch.no_grad():
        _close(model(torch.from_numpy(x)), ref_eval, 1e-4)


@pytest.mark.parametrize("scale", [1, 4], ids=["x1", "x4"])
def test_fstrn_matches_jax(scale):
    """FSTRN (3-D convs, the (1, s, s) transposed conv, the trilinear
    cross-space residual) at x1 and x4, 3 frames."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 8, 10, 3), np.float32)
    jmodel = JaxFSTRN(k=3, nf=8, scale=scale, nframes=3)
    variables = random_variables(jmodel, rng, jnp.asarray(x))
    model = _port(FSTRN(3, 8, scale, 3, device="cpu"), variables)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)),
               _jax_forward(jmodel, variables, x)[0], 1e-4)


def test_fstrn_trains_without_dropout_as_the_jax_trainer_applies_it():
    """The JAX trainer applies BN-free models without ``train=True``
    (``realvsr_tpu/train/wrappers.py:48``), so FSTRN's Dropout(0.3) is off
    there: the port's training forward (``train()``, gradients on) equals
    its eval forward and JAX's apply, and JAX's own ``train=True`` apply,
    which no path of the JAX package makes, differs."""
    rng = np.random.default_rng(4)
    x = rng.random((1, 3, 8, 8, 3), np.float32)
    jmodel = JaxFSTRN(k=3, nf=8, scale=1, nframes=3)
    variables = random_variables(jmodel, rng, jnp.asarray(x))
    model = _port(FSTRN(3, 8, 1, 3, device="cpu"), variables)
    model.train()
    out_train = model(torch.from_numpy(x))
    model.eval()
    with torch.no_grad():
        out_eval = model(torch.from_numpy(x))
    assert torch.equal(out_train.detach(), out_eval)
    _close(out_train, _jax_forward(jmodel, variables, x)[0], 1e-4)
    dropped = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, rngs={"dropout": jax.random.PRNGKey(0)}))(
            variables, jnp.asarray(x))
    assert not np.allclose(np.asarray(dropped), out_eval.numpy(), atol=1e-3)


@pytest.mark.parametrize("scale", [1, 2], ids=["x1", "x2"])
def test_rcan_matches_jax(scale):
    """RCAN with 3 frames flattened into 9 channels, 2 groups of 2 RCABs
    (channel attention squeezing 16 to 4), at x1 and x2."""
    rng = np.random.default_rng(5)
    x = rng.random((2, 3, 10, 12, 3), np.float32)
    jmodel = JaxRCAN(num_in_ch=3, num_out_ch=3, num_frames=3, num_feat=16,
                     num_group=2, num_block=2, squeeze_factor=4,
                     upscale=scale)
    variables = random_variables(jmodel, rng, jnp.asarray(x))
    model = _port(RCAN(3, 3, 3, 16, 2, 2, 4, scale, device="cpu"),
                  variables)
    with torch.no_grad():
        _close(model(torch.from_numpy(x)),
               _jax_forward(jmodel, variables, x)[0], 1e-4)
