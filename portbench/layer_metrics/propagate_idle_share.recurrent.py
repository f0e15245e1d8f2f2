"""100 x the share of the port's ``restore.propagate`` span time (inside
the traced window) in which the device ran nothing: while the host
launches a branch's steps, the device waiting for them, the launch-bound
share of the propagation.  None where the port records no such span."""
from portbench.layer_metrics._spans import idle_ns_in, spans


def read(r):
    found = spans("restore.propagate")
    if r.timeline is None or found is None:
        return None
    idle, total = idle_ns_in(r.timeline, found)
    return 100.0 * idle / total if total > 0 else None
