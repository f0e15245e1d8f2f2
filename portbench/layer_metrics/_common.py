"""What the per-layer readers share.  Each metric is one file
``<name>.py`` with ``read(readings) -> float | None``; None where the run
gave it nothing to read, and the harness then leaves the metric out."""
from __future__ import annotations

from portbench.roofline import PEAK_TC_FLOPS


def idle_share(r) -> float | None:
    """100 x the share of the traced window in which no operation ran on
    the device."""
    if r.timeline is None:
        return None
    return 100.0 * r.timeline.idle_share()


def mfu(r) -> float | None:
    """100 x the model's operations over the traced window (the plain
    reference's count a unit x the units done) over the peak of the
    tensor cores at the cell's precision."""
    if r.units == 0 or r.window_s <= 0:
        return None
    return (100.0 * r.flops_per_unit * r.units / r.window_s
            / PEAK_TC_FLOPS[r.dtype])
