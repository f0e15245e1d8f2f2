"""Seeded inputs for the port's parity tests against the JAX package.

:func:`random_variables`: seeded random variables for a flax module of
the JAX package, without compiling its init: ``jax.eval_shape`` gives the tree, numpy fills it
(XLA's compile of an init with many random leaves takes seconds on the
CPU, its shape pass a fraction of one).

Kernels (convs, Dense, transposed convs, the DCN's ``weight``) are
N(0, 1/fan_in), fan_in the product of all axes but the last; biases
N(0, 0.1); BN scales 1 + N(0, 0.05), running means N(0, 0.1), running
variances 1 + |N(0, 0.1)|; PReLU slopes 0.25 + N(0, 0.05).  Every leaf is
off the JAX init's constants, so a key or layout carried over wrong shows.

:func:`smooth_batch`: an AllPair batch of smooth frames.
"""
import cv2
import jax
import numpy as np


def _leaf(name, shape, rng):
    if name in ("kernel", "weight") and len(shape) >= 2:
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(size=shape) / np.sqrt(fan_in)
    if name == "scale":
        return 1 + rng.normal(size=shape) * 0.05
    if name == "var":
        return 1 + np.abs(rng.normal(size=shape)) * 0.1
    if name == "alpha":
        return 0.25 + rng.normal(size=shape) * 0.05
    return rng.normal(size=shape) * 0.1


def _fill(tree, rng):
    return {k: _fill(v, rng) if hasattr(v, "items") else
            _leaf(k, v.shape, rng).astype(np.float32)
            for k, v in tree.items()}


def random_variables(module, rng, *args, **kwargs):
    """A variables dict (``{"params"}``, and ``"batch_stats"`` for a BN
    model) of ``module`` applied to ``args``, as nested dicts of float32
    numpy arrays drawn from ``rng``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                            **kwargs)
    return _fill(shapes, rng)


def smooth_batch(side, seed, frames=3, batch=2):
    """LQ and GT windows (batch, frames, side, side, 3) of smooth frames
    (bicubic from 1/6 size, as images are) plus a little noise, float32 in
    [0, 1]: an SSIM of a pyramid's small base level on white noise is a
    difference of nearly equal f32 sums."""
    rng = np.random.default_rng(seed)

    def clip():
        f = np.stack([cv2.resize(
            rng.random((side // 6, side // 6, 3)).astype(np.float32),
            (side, side), interpolation=cv2.INTER_CUBIC)
            for _ in range(batch * frames)])
        f = f.reshape(batch, frames, side, side, 3)
        return np.clip(f + rng.normal(size=f.shape) * 0.02, 0, 1).astype(
            np.float32)

    return {"LQs": clip(), "GT": clip()}
