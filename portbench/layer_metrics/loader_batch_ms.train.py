"""Mean host milliseconds the loader's producer thread spent making one
batch in the traced window: its ``loader.fetch`` (the samples, on the
worker pool) plus its ``loader.collate`` (stacking them), over the batches
with both spans.  None where the port records no such span."""
from collections import defaultdict


def read(r):
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own spans
        return None
    parts = defaultdict(dict)
    for s in trace.spans():
        if s.name in ("loader.fetch", "loader.collate"):
            parts[s.req][s.name] = s.end_ns - s.start_ns
    whole = [sum(p.values()) for p in parts.values() if len(p) == 2]
    return 1e-6 * sum(whole) / len(whole) if whole else None
