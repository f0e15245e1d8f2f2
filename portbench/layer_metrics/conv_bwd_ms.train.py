"""Device milliseconds a step of the traced window of the ops launched
inside the port's ``kernel.conv3x3_bwd`` spans (the conv3x3 backward's
cuDNN data and weight gradients, with the bias gradient and the weight's
copy beside them).  A launch belongs to a span by its time alone: while
backward runs only the autograd thread launches.  None where the port
records no such span."""
import bisect


def read(r):
    tl = r.timeline
    if tl is None or r.units == 0:
        return None
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own spans
        return None
    spans = sorted((s.start_ns, s.end_ns)
                   for s in trace.spans("kernel.conv3x3_bwd"))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    inside = set()
    for corr, (t, _) in tl.launch.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= spans[i][1]:
            inside.add(corr)
    ns = sum(e - s for s, e, _, corr in tl.device if corr in inside)
    return 1e-6 * ns / r.units
