"""The discriminators, the VGG modules, BatchNorm and the GAN losses of the
port (``realvsr_tpu_torch/models/{discriminators,vgg,common}.py``,
``losses/gan.py``) against the JAX package on the CPU in f32.

JAX variables are seeded random (``torch_jax_params``: every leaf off
the init's constants, BN running statistics included) and carried over
with ``state_dict_from_jax``, which must load with ``strict=True`` (Dense
and transposed-conv layouts included).  Train mode is held against JAX's mutable apply (outputs and
the running statistics it writes), eval mode against its ``train=False``
apply on those statistics.

Tolerance: 1e-4 of the output's largest magnitude (f32 convs summed in
other orders; BN divides by batch deviations of order 1e-1), running
statistics 1e-5 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.losses.gan import gan_loss as jax_gan_loss
from realvsr_tpu.losses.gan import gradient_penalty as jax_gradient_penalty
from realvsr_tpu.models import define_d as jax_define_d
from realvsr_tpu.models import vgg as JV
from realvsr_tpu.models.common import BatchNorm2d as JaxBatchNorm2d
from realvsr_tpu_torch.convert import state_dict_from_jax
from realvsr_tpu_torch.losses import gan_loss, gradient_penalty
from realvsr_tpu_torch.models import define_d, define_f
from realvsr_tpu_torch.models import vgg as V
from realvsr_tpu_torch.models.common import BatchNorm2d, updating_batch_stats
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


def _train_and_eval(jmodel, variables, *args):
    """JAX's mutable train-mode apply and its eval apply on the statistics
    that one writes, in one compile: (train out, batch_stats, eval out)."""
    def both(v, *a):
        out, mut = jmodel.apply(v, *a, train=True, mutable=["batch_stats"])
        stats = mut.get("batch_stats", {})
        return out, stats, jmodel.apply(
            {"params": v["params"], "batch_stats": stats}, *a, train=False)

    return jax.jit(both)(variables, *args)


def _close(out, ref, rel=1e-4):
    ref = torch.as_tensor(np.asarray(ref, np.float32))
    top = max(ref.abs().max().item(), 1e-6)
    torch.testing.assert_close(out.detach().float(), ref, rtol=0,
                               atol=rel * top)


def _flat(x):
    return x if isinstance(x, (list, tuple)) else [x]


def _inputs(which, rng):
    """(JAX args, port args) of a discriminator: an image, a list of
    pyramid levels (v3 / v4) or two lists (image-gradient v2)."""
    def img(s, c=1):
        return rng.random((2, s, s, c), np.float32)

    if which == "MultiscaleDiscriminator_v3":   # D_2 (1 block) on 64,
        arrs = [[img(64), img(32), img(16)]]   # D_0 (3) on 16: 2x2 out
    elif which == "MultiscaleDiscriminator_v4":
        arrs = [[img(32), img(16)]]
    elif which == "ImageGradientPyramidDiscriminator_v2":
        arrs = [[img(32), img(16)], [img(32), img(16)]]
    elif which.startswith("discriminator_vgg"):
        arrs = [img(int(which[-3:]), 3)]
    else:
        arrs = [img(32)]

    def conv(a, f):
        return [conv(v, f) for v in a] if isinstance(a, list) else f(a)

    return (conv(arrs, jnp.asarray), conv(arrs, torch.from_numpy))


# which_model_D: num_D (the pyramids' levels)
D_TYPES = {
    "PatchDiscriminator": None, "PixelDiscriminator": None,
    "UNetDiscriminator": None, "MultiscaleDiscriminator_v1": 3,
    "MultiscaleDiscriminator_v2": 3, "MultiscaleDiscriminator_v3": 3,
    "MultiscaleDiscriminator_v4": 2, "LaplacePyramidDiscriminator": 3,
    "GaussianPyramidDiscriminator": 2,
    "ImageGradientPyramidDiscriminator_v1": 2,
    "ImageGradientPyramidDiscriminator_v2": 2,
    "discriminator_vgg_128": None, "discriminator_vgg_192": None,
}


@pytest.mark.parametrize("which", list(D_TYPES))
def test_define_d_matches_jax_in_train_and_eval(which):
    """Every ``define_d`` type from the same YAML keys: the train-mode
    forward (batch statistics) and the running statistics it writes under
    ``updating_batch_stats`` against JAX's ``mutable=["batch_stats"]``
    apply; a train-mode forward outside it writes none; then the eval
    forward on the written statistics."""
    vgg = which.startswith("discriminator_vgg")
    opt = {"network_D": dict(which_model_D=which, in_nc=3 if vgg else 1,
                             nf=4 if vgg else 8, num_D=D_TYPES[which],
                             gan_type="patch")}
    rng = np.random.default_rng(0)
    jargs, targs = _inputs(which, rng)
    jmodel = jax_define_d(opt)
    variables = random_variables(jmodel, rng, *jargs)
    model = define_d(opt, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()

    before = {k: v.clone() for k, v in model.state_dict().items()}
    out = model(*targs)
    assert all(torch.equal(before[k], v)
               for k, v in model.state_dict().items())
    with updating_batch_stats(model):
        out = model(*targs)
    ref, bstats, ref_eval = _train_and_eval(jmodel, variables, *jargs)
    assert len(_flat(out)) == len(_flat(ref))
    for o, r in zip(_flat(out), _flat(ref)):
        assert o.shape == r.shape
        _close(o, r)
    written = state_dict_from_jax({"params": variables["params"],
                                   "batch_stats": bstats})
    stats = {k: v for k, v in written.items() if "running" in k}
    # the UNet's SimpleBlocks of depth 2 have no BN
    assert bool(stats) == (which != "UNetDiscriminator")
    sd = model.state_dict()
    for k, v in stats.items():
        torch.testing.assert_close(sd[k], v, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"{k}: {m}")
    model.eval()
    with torch.no_grad():
        out = model(*targs)
    for o, r in zip(_flat(out), _flat(ref_eval)):
        _close(o, r)


def test_batchnorm_is_the_jax_rule_and_loads_torch_state_dicts():
    """BatchNorm2d alone, f32 and bf16 input: train-mode output and the
    unbiased momentum update against JAX's; eval on running statistics;
    ``num_batches_tracked`` counts the updates and may be absent from a
    state dict loaded with strict=True; ``nn.BatchNorm2d``'s state dict
    loads too."""
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(3, 5, 7, 4)) * 2 + 1).astype(np.float32)
    jbn = JaxBatchNorm2d()
    variables = random_variables(jbn, rng, jnp.asarray(x))
    bn = BatchNorm2d(4)
    bn.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert bn.num_batches_tracked.item() == 0
    bn.train()
    with updating_batch_stats(bn):
        out = bn(torch.from_numpy(x))
    ref, stats, ref_eval = _train_and_eval(jbn, variables, jnp.asarray(x))
    _close(out, ref, 1e-5)
    for leaf in ("mean", "var"):
        torch.testing.assert_close(
            getattr(bn, f"running_{leaf}"),
            torch.from_numpy(np.asarray(stats[leaf])), rtol=1e-6, atol=1e-7)
    assert bn.num_batches_tracked.item() == 1
    bn.eval()
    _close(bn(torch.from_numpy(x)), ref_eval, 1e-5)
    # bf16 input: statistics in f32, output in bf16, as JAX's
    bn.train()
    xb = torch.from_numpy(x).to(torch.bfloat16)
    ref = jbn.apply(variables, jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                    train=True)
    out = bn(xb)
    assert out.dtype == torch.bfloat16
    _close(out, np.asarray(ref, np.float32), 2e-2)
    torch_bn = torch.nn.BatchNorm2d(4)
    bn.load_state_dict(torch_bn.state_dict(), strict=True)
    assert torch.equal(bn.running_var, torch.ones(4))


@pytest.mark.parametrize("use_bn", [False, True], ids=["34", "49_bn"])
def test_vgg_feature_extractor_matches_jax(use_bn):
    """``define_f`` (layer 34, or 49 with BN) in eval mode, against JAX's
    extractor, on 3-channel images and on a 1-channel LF base (which
    broadcasts against the ImageNet mean and std into 3 channels); the
    input takes a gradient, the frozen weights none."""
    rng = np.random.default_rng(2)
    jmodel = JV.VGGFeatureExtractor(feature_layer=49 if use_bn else 34,
                                    use_bn=use_bn)
    x3 = rng.random((2, 32, 32, 3), np.float32)
    variables = random_variables(jmodel, rng, jnp.asarray(x3))
    apply = jax.jit(jmodel.apply)
    model = define_f(None, use_bn=use_bn, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()   # stays in eval mode
    for x in (x3, x3[..., :1]):
        xt = torch.from_numpy(x).requires_grad_(True)
        out = model(xt)
        _close(out, apply(variables, jnp.asarray(x)))
        out.sum().backward()
        assert xt.grad.abs().max() > 0
    assert all(p.grad is None for p in model.parameters())


def test_load_vgg19_weights_and_vgg19_slices_match_jax(tmp_path):
    """``load_vgg19_weights`` from a torchvision-format ``vgg19`` file the
    test writes (``features.{i}``) gives the JAX loader's parameters and
    features; ``Vgg19``'s three slices match JAX's."""
    rng = np.random.default_rng(3)
    sd, idx, cin = {}, 0, 3
    for item in V._VGG19_PLAN:
        if item == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.normal(size=(item, cin, 3, 3)).astype(np.float32)
            / np.sqrt(9 * cin))
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.normal(size=item).astype(np.float32) * 0.1)
        idx, cin = idx + 2, item
    path = str(tmp_path / "vgg19.pth")
    torch.save(sd, path)
    x = rng.random((1, 32, 32, 3), np.float32)
    jmodel = JV.VGGFeatureExtractor()
    jparams = JV.load_vgg19_weights(
        random_variables(jmodel, rng, jnp.asarray(x))["params"], path)
    model = define_f(None, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    V.load_vgg19_weights(model, path)
    ours = model.state_dict()
    for k, v in state_dict_from_jax(jparams).items():
        assert torch.equal(ours[k], v), k
    _close(model(torch.from_numpy(x)),
           jax.jit(jmodel.apply)({"params": jparams}, jnp.asarray(x)))

    jv = JV.Vgg19()
    variables = random_variables(jv, rng, jnp.asarray(x))
    v19 = V.Vgg19(device="cpu")
    v19.load_state_dict(state_dict_from_jax(variables), strict=True)
    for o, r in zip(v19(torch.from_numpy(x)),
                    jax.jit(jv.apply)(variables, jnp.asarray(x))):
        _close(o, r)


def test_gan_losses_and_gradient_penalty_match_jax():
    """``gan_loss`` for gan / ragan / lsgan / wgan-gp, real and fake, and
    the WGAN-GP penalty through a Patch discriminator (its gradient by the
    input, and the penalty's own gradient by D's weights, which
    ``create_graph=True`` keeps)."""
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 8, 8, 1)).astype(np.float32) * 3
    for gan_type in ("gan", "ragan", "lsgan", "wgan-gp"):
        for real in (True, False):
            ref = float(jax_gan_loss(jnp.asarray(logits), real, gan_type))
            got = gan_loss(torch.from_numpy(logits), real, gan_type).item()
            assert got == pytest.approx(ref, rel=1e-6, abs=1e-7)
    with pytest.raises(NotImplementedError):
        gan_loss(torch.from_numpy(logits), True, "hinge")

    opt = {"network_D": dict(which_model_D="PatchDiscriminator", in_nc=1,
                             nf=8, num_D=None, gan_type="patch")}
    interp = rng.random((2, 16, 16, 1), np.float32)
    jmodel = jax_define_d(opt)
    variables = random_variables(jmodel, rng, jnp.asarray(interp))

    def d_apply(params, x):
        return jmodel.apply({"params": params,
                             "batch_stats": variables["batch_stats"]}, x,
                            train=True)

    ref, ref_grad = jax.jit(jax.value_and_grad(
        lambda p: jax_gradient_penalty(d_apply, p, jnp.asarray(interp))))(
            variables["params"])
    model = define_d(opt, device="cpu")
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    model.train()
    gp = gradient_penalty(model, torch.from_numpy(interp))
    assert gp.item() == pytest.approx(float(ref), rel=1e-4)
    gp.backward()
    # the biases of the convs before a BN get zero gradients but for
    # rounding (BN takes out the mean): all held to 1e-4 of the largest
    grads = state_dict_from_jax(jax.device_get(ref_grad))
    top = max(g.abs().max().item() for g in grads.values())
    for k, p in model.named_parameters():   # conv_out.bias: no gradient
        g = torch.zeros_like(p) if p.grad is None else p.grad
        torch.testing.assert_close(g, grads[k], rtol=0, atol=1e-4 * top,
                                   msg=lambda m: f"{k}: {m}")
