"""The model's share of the card's peak over the traced window: the plain
reference's operation count a frame (``reference/basicvsrpp.py::
model_flops``), times the frames handed back, over the window, over the
tensor cores' peak at the cell's precision."""
from portbench.layer_metrics._common import mfu as read  # noqa: F401
