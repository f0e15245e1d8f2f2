"""Training EDVR x4 + TSA in the port against the JAX package on the CPU:
one Split step (loss, every gradient, every parameter after Adam; with the
exact and the ±R block DCN) and three steps of ``ft_tsa_only`` against the
JAX package's masked optimizer chain.  TDAN's step, the command line and
the helpers shared here are in ``test_torch_train_families.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models import define_g as jax_define_g
from test_torch_train_families import (_batch, _close_params, _jax_steps,
                                       _opt, _port, _port_step,
                                       _randomise_offset_convs,
                                       hold_split_step, setup_family)


@pytest.fixture(scope="module")
def edvr_x4_tsa():
    return setup_family("edvr_x4_tsa")


@pytest.mark.parametrize("impl", ["exact", "block"])
def test_split_step_matches_jax(edvr_x4_tsa, impl):
    """EDVR x4 + TSA's Split step against JAX's, as
    ``test_torch_train_families.py::hold_split_step`` holds it."""
    hold_split_step(edvr_x4_tsa, impl)


def test_ft_tsa_only_three_steps_match_jax():
    """``ft_tsa_only: 2`` on EDVR x4 + TSA: the first update moves only the
    ``tsa_fusion`` parameters (the rest bit-unchanged, as the JAX package's
    update mask leaves them), the next two move all.  Each step's loss to
    1e-4 relative of JAX's; parameters after each step to k * 2 LR after k
    steps (each Adam update is at most ~LR: ``hold_split_step``)."""
    name = "edvr_x4_tsa"
    batch = _batch(name)
    opt = _opt(name, ft_tsa_only=2)
    jmodel = jax_define_g(opt)
    params = jax.tree.map(np.asarray, jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(batch["LQs"]))["params"]))
    _randomise_offset_convs(params, np.random.default_rng(1), std=0.5)
    losses, _, after = _jax_steps(opt, jmodel, params, batch, 3)
    model, state = _port(opt, params, None)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    lr = float(opt["train"]["lr_G"])
    assert [g["lr"] for g in state.optimizer.param_groups][0] == 0.0
    for i in range(3):
        loss = _port_step(model, state, opt, batch)
        assert loss == pytest.approx(losses[i], rel=1e-4), i
        named = dict(model.named_parameters())
        _close_params(named, after[i], (i + 1) * 2.0001 * lr)
        if i == 0:  # only tsa_fusion moved, on both sides
            for k, v in named.items():
                frozen = "tsa_fusion" not in k
                assert torch.equal(v.detach(), before[k]) == frozen, k
                assert torch.equal(after[0][k], before[k]) == frozen, k
    assert all(not torch.equal(v.detach(), before[k])
               for k, v in model.named_parameters())
    assert state.step == 3
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        state.optimizer.param_groups[1]["lr"])
