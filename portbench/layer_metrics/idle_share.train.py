"""Share of the traced window in which the device ran nothing, from
torch.profiler's timeline (1 - the union of kernel, memcpy and memset
intervals / the window)."""
from portbench.layer_metrics._common import idle_share as read  # noqa: F401
