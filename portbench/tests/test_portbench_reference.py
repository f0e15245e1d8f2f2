"""The plain reference against the port's CPU path at small sizes: the EDVR
family's forwards, the DCN, the Split losses, the augmentation's draws and
Adam under the recipe's schedule."""
import copy

import pytest
import torch

from portbench.reference import dcn as ref_dcn
from portbench.reference import edvr, split
from portbench.weights import make_params

NETS = {
    "edvr_noup": dict(which_model_G="EDVR_NoUp", nf=16, nc=3, nframes=3,
                      groups=8, front_RBs=2, back_RBs=2, w_TSA=False),
    "edvr_tsa_x4": dict(which_model_G="EDVR", nf=32, nc=3, nframes=5,
                        groups=8, front_RBs=1, back_RBs=2, w_TSA=True),
}
RECIPE = {"lr_G": 1e-4, "lr_scheme": "CosineAnnealingLR_Restart",
          "beta1": 0.9, "beta2": 0.99, "niter": 150000, "warmup_iter": -1,
          "T_period": [150000, 150000, 150000, 150000],
          "restarts": [150000, 300000, 450000], "restart_weights": [1, 1, 1],
          "eta_min": 1e-7, "pixel_criterion_y": "lappyr",
          "pixel_weight_y": 1.0, "pixel_criterion_c": "gw",
          "pixel_weight_c": 1.0}


@pytest.mark.parametrize("name", sorted(NETS))
def test_forward_matches_the_port(name):
    from realvsr_tpu_torch.models import define_g

    net = NETS[name]
    params = make_params(edvr.param_specs(net), 3, "cpu", torch.float32, 4.0)
    scale = 4 if net["which_model_G"] == "EDVR" else 1
    model = define_g({"network_G": net, "scale": scale}, device="cpu",
                     dcn_max_offset=4.0)
    model.load_state_dict(params, strict=True)
    x = torch.rand(2, net["nframes"], 16, 24, 3,
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x)
        want, res = edvr.forward(net, params, x, 4.0)
    diff = got - want.permute(0, 2, 3, 1)
    assert diff.pow(2).mean().sqrt() < 1e-5 * res.pow(2).mean().sqrt()


@pytest.mark.parametrize("max_offset", [None, 2.0])
def test_dcn_matches_the_ports_plain_op(max_offset):
    from realvsr_tpu_torch.ops.deform_conv import modulated_deform_conv_plain

    g = torch.Generator().manual_seed(0)
    b, c, h, w, dg = 2, 16, 9, 11, 4
    x = torch.randn(b, c, h, w, generator=g)
    off = torch.randn(b, dg * 18, h, w, generator=g) * 3
    mask = torch.rand(b, dg * 9, h, w, generator=g)
    wt = torch.randn(8, c, 3, 3, generator=g) * 0.1
    bias = torch.randn(8, generator=g)
    want = modulated_deform_conv_plain(
        x.permute(0, 2, 3, 1), off.permute(0, 2, 3, 1),
        mask.permute(0, 2, 3, 1), wt, bias, 1, 1, 1, dg, max_offset, None)
    got = ref_dcn.modulated_deform_conv(x, off, mask, wt, bias, dg,
                                        max_offset, block=1)
    torch.testing.assert_close(got.permute(0, 2, 3, 1), want, rtol=1e-5,
                               atol=1e-5)


def test_split_losses_match_the_ports():
    from realvsr_tpu_torch.losses import get_pixel_criterion

    g = torch.Generator().manual_seed(2)
    x = torch.rand(3, 48, 52, 3, generator=g)
    y = torch.rand(3, 48, 52, 3, generator=g)
    l_y, l_c = split.split_loss(x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2),
                                RECIPE)
    torch.testing.assert_close(
        l_y, get_pixel_criterion("lappyr")(x[..., :1], y[..., :1]))
    torch.testing.assert_close(
        l_c, get_pixel_criterion("gw")(x[..., 1:], y[..., 1:]))


@pytest.mark.parametrize("mix_p", [[0.95, 0.05], [0.0, 1.0]])
def test_augmentation_draws_as_the_port(mix_p):
    from realvsr_tpu_torch.data.augments import apply_augment

    aug = {"augs": ["none", "cutblur"], "probs": [1.0, 1.0], "mix_p": mix_p,
           "alphas": [1.0, 0.7]}
    g = torch.Generator().manual_seed(3)
    gt = torch.rand(2, 3, 20, 24, 3, generator=g)
    lq = torch.rand(2, 3, 20, 24, 3, generator=g)
    for seed in range(4):
        want = apply_augment(torch.Generator().manual_seed(seed), gt, lq,
                             aug["augs"], aug["probs"], aug["alphas"],
                             aug["mix_p"])
        got = split.augment(torch.Generator().manual_seed(seed), gt, lq, aug)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_adam_follows_the_ports_optimizer():
    from realvsr_tpu_torch.train.state import build_optimizer

    g = torch.Generator().manual_seed(4)
    p0 = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(7,
                                                               generator=g)}
    ref = {k: v.clone().requires_grad_() for k, v in p0.items()}
    port = {k: torch.nn.Parameter(v.clone()) for k, v in p0.items()}
    opt, sched = build_optimizer(port.items(), copy.deepcopy(RECIPE))
    adam = split.Adam(ref, RECIPE)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in p0.items()}
        for k in p0:
            ref[k].grad = grads[k].clone()
            port[k].grad = grads[k].clone()
        adam.step()
        opt.step()
        sched.step()
    for k in p0:
        torch.testing.assert_close(ref[k].detach(), port[k].detach(),
                                   rtol=1e-6, atol=1e-9)
