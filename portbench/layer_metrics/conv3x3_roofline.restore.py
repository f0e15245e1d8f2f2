"""The conv3x3 kernel's share of its roofline over the traced window: the
least time of each call (``roofline/conv3x3.py``) summed, over the device
time of the ops the calls launched."""
from portbench.roofline import share


def read(r):
    return share(r, ["conv3x3"])
