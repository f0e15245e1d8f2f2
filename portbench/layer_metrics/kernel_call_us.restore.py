"""Mean host microseconds of one call into the conv3x3 or DCN forward
kernel over the traced window (the port's ``kernel.conv3x3`` and
``kernel.dcn_fwd`` spans: checks, planning and launch, not the device's
time).  None where the port records no such span."""


def read(r):
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own spans
        return None
    spans = [s for s in trace.spans()
             if s.name in ("kernel.conv3x3", "kernel.dcn_fwd")]
    if not spans:
        return None
    return 1e-3 * sum(s.end_ns - s.start_ns for s in spans) / len(spans)
