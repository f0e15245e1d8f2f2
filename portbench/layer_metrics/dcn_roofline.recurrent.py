"""The DCN forward kernels' share of their roofline over the traced window
(``roofline/dcn_fwd.py``): in BasicVSR++ the second-order alignment's
128 -> 64 DCN in 16 groups with exact offsets (``csrc/dcn_narrow.cu``)."""
from portbench.roofline import share


def read(r):
    return share(r, ["dcn_fwd"])
