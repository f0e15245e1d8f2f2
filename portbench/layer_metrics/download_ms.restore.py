"""Mean host milliseconds a frame of the traced window spent in the restore
entry's download (the port's ``restore.download`` spans: the float32
output's copy from the card, after its stream was waited for).  None where
the port records no such span."""


def read(r):
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own spans
        return None
    spans = trace.spans("restore.download")
    if not spans:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans) / len(spans)
