"""Device milliseconds a frame of the ops launched inside the port's
``restore.propagate`` spans (the four propagation branches: warps, the
second-order alignment with its DCN, the backbones), over the frames of
the clips whose flows ran in the traced window.  None where the port
records no such span."""
from portbench.layer_metrics._spans import per_frame_ms


def read(r):
    return per_frame_ms(r, "restore.propagate")
