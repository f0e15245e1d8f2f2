"""Plain PyTorch references of what the benchmark's cells run.

Everything here is written from the published descriptions (EDVR's
``EDVR_arch.py``, mmcv's modulated deformable convolution, the RealVSR
repository's Split losses, Adam) in NCHW float32, with TF32 off.  It imports
nothing of the package under test: the benchmark makes the weights and the
inputs, hands the same ones to both sides, and this package works out the
rest itself.
"""
import importlib


def family(name: str):
    """The reference module a configuration names (``reference`` key)."""
    return importlib.import_module(f"portbench.reference.{name}")
