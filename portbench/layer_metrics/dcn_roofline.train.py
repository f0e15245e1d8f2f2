"""The DCN forward and backward kernels' share of their roofline over the
traced training window (``roofline/dcn_fwd.py``, ``roofline/dcn_bwd.py``):
both families' least times over both families' device time."""
from portbench.roofline import share


def read(r):
    return share(r, ["dcn_fwd", "dcn_bwd"])
