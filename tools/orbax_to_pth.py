#!/usr/bin/env python
"""Convert an Orbax network checkpoint of the JAX package into a ``.pth``
state dict that the PyTorch port loads with ``load_state_dict(strict=True)``.

    python tools/orbax_to_pth.py -opt configs/train/<experiment>.yml \
        --ckpt experiments/<name>/models/<iter>_G --out <iter>_G.pth [--D]

The JAX trainer saves ``<iter>_G`` (and a GAN's ``<iter>_D``) as Orbax
directories: the parameters, or ``{"params", "batch_stats"}`` for a model
with BatchNorm.  This script builds the config's G (or, with ``--D``, its
D) with the JAX package for the tree's shapes, restores the directory with
``realvsr_tpu.train.checkpoint.load_network`` and writes the tree through
``realvsr_tpu_torch.convert.state_dict_from_jax`` under the reference's
key names.  It needs JAX, flax and orbax, so it runs where the JAX package
runs (not on a machine with only the port); it is the one file that imports
both packages.
"""
import argparse
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

import numpy as np  # noqa: E402


def template(opt: dict, discriminator: bool):
    """Zeros of the tree an Orbax checkpoint of the config's G or D holds
    (the variables dict when the model has BatchNorm statistics)."""
    import jax
    import jax.numpy as jnp

    from realvsr_tpu.core.config import dict_to_nonedict
    from realvsr_tpu.models import define_d, define_g
    from realvsr_tpu.ops.pyramid import laplacian_pyramid

    opt = dict_to_nonedict(opt)   # absent keys read as None, as parsed
    train = (opt.get("datasets") or {}).get("train") or {}
    size = train.get("GT_size") or 64
    net = opt["network_G"]
    lq = size // (opt.get("scale") or 1)
    sample = jnp.zeros((1, net.get("nframes") or 3, lq, lq,
                        net.get("nc") or 3), jnp.float32)
    if discriminator:
        model = define_d(opt)
        y = jnp.zeros((1, size, size, 1), jnp.float32)
        args = (laplacian_pyramid(y, max_levels=3)[:-1],)
    else:
        model = define_g(opt)
        args = (sample,)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)
    tree = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    if tree.get("batch_stats"):
        return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
    return tree["params"]


def convert(opt: dict, ckpt: str, out: str, discriminator: bool = False
            ) -> dict:
    """Restore ``ckpt`` (an Orbax directory, or a ``.pth`` through the JAX
    package's importer) into the config's tree and save it to ``out`` as a
    port state dict; returns that state dict."""
    import jax
    import torch

    from realvsr_tpu.train.checkpoint import load_network
    from realvsr_tpu_torch.convert import state_dict_from_jax

    tree = load_network(ckpt, template(opt, discriminator))
    sd = state_dict_from_jax(jax.tree.map(np.asarray, jax.device_get(tree)))
    torch.save(sd, out)
    return sd


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-opt", required=True, help="the training YAML")
    parser.add_argument("--ckpt", required=True,
                        help="the Orbax directory (<iter>_G or <iter>_D)")
    parser.add_argument("--out", required=True, help="the .pth to write")
    parser.add_argument("--D", action="store_true",
                        help="the checkpoint is the GAN's discriminator")
    args = parser.parse_args(argv)
    import yaml

    with open(args.opt) as f:
        opt = yaml.safe_load(f)
    sd = convert(opt, args.ckpt, args.out, args.D)
    print(f"wrote {len(sd)} tensors to {args.out}")


if __name__ == "__main__":
    main()
