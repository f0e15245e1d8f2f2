"""Weights carried from the JAX package to the port (``state_dict_from_jax``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realvsr_tpu.models.edvr import EDVRNoUp as JaxEDVRNoUp
from realvsr_tpu.train.torch_import import (
    export_to_torch_state_dict, flax_path_to_torch_key as jax_key,
    import_torch_state_dict)
from realvsr_tpu_torch.convert import flax_path_to_torch_key, state_dict_from_jax
from realvsr_tpu_torch.models.edvr import EDVRNoUp

CFG = dict(nf=16, nc=3, nframes=3, groups=4, front_RBs=2, back_RBs=2,
           w_TSA=False)


@pytest.fixture(scope="module")
def jax_params():
    model = JaxEDVRNoUp(**CFG)
    return jax.device_get(model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 16, 16, 3)))["params"])


def test_state_dict_equals_export_to_torch_state_dict(jax_params):
    ours = state_dict_from_jax(jax_params)
    ref = export_to_torch_state_dict(jax_params)
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours["pcd_align.L1_dcnpack.weight"].shape == (16, 16, 3, 3)
    assert ours["tsa_fusion.weight"].shape == (16, 48, 1, 1)


def test_state_dict_loads_strict_into_port_model(jax_params):
    model = EDVRNoUp(**CFG, device="cpu")
    missing = model.load_state_dict(state_dict_from_jax(jax_params),
                                    strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    sd = model.state_dict()
    for key in ("feature_extraction.1.conv2.weight",
                "pcd_align.cas_dcnpack.conv_offset_mask.bias",
                "recon_trunk.1.conv1.weight", "HRconv.weight",
                "conv_last.bias"):
        assert key in sd


def test_port_state_dict_imports_back_into_jax(jax_params):
    """The port's own weights round-trip through the JAX package's .pth
    importer, so a state dict saved by the port is a reference .pth."""
    model = EDVRNoUp(**CFG, device="cpu",
                     generator=torch.Generator().manual_seed(5))
    back = import_torch_state_dict(jax_params, model.state_dict(), strict=True)
    again = state_dict_from_jax(jax.device_get(back))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(again[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("path", [
    ("conv_first", "Conv_0", "kernel"),
    ("feature_extraction", "block3", "conv1", "Conv_0", "bias"),
    ("pcd_align", "L2_dcnpack", "weight"),
    ("bn", "scale"), ("bn", "mean"), ("bn", "var"),
])
def test_key_rules_match_jax_package(path):
    assert flax_path_to_torch_key(path) == jax_key(path)
