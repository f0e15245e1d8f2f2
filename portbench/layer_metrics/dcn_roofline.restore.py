"""The DCN forward kernels' share of their roofline over the traced
window (``roofline/dcn_fwd.py``)."""
from portbench.roofline import share


def read(r):
    return share(r, ["dcn_fwd"])
