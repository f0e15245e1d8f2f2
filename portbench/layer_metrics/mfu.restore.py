"""The model's share of the card's peak over the traced window: the plain
reference's operation count a unit of work, times the units done, over
the window, over the tensor cores' peak at the cell's precision."""
from portbench.layer_metrics._common import mfu as read  # noqa: F401
