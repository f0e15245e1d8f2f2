"""100 x the device's idle seconds inside the main thread's
``restore.download`` spans (the complement of the union of the timeline's
device intervals, on the clock the spans and the trace share) over the
traced window.  A part of ``idle_share.restore``.  None where the port
records no such span."""
import threading


def _busy(device, t0, t1):
    merged = []
    for s, e, _, _ in sorted(device):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _idle_ns(spans, busy):
    """Nanoseconds of the (sorted, disjoint) ``spans`` that no interval of
    ``busy`` (sorted, disjoint) covers."""
    idle, i = 0, 0
    for a, b in spans:
        while i < len(busy) and busy[i][1] <= a:
            i += 1
        t, j = a, i
        while j < len(busy) and busy[j][0] < b:
            idle += max(0, busy[j][0] - t)
            t = max(t, busy[j][1])
            j += 1
        idle += max(0, b - t)
    return idle


def read(r):
    tl = r.timeline
    if tl is None:
        return None
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own spans
        return None
    main = threading.main_thread().native_id
    spans = sorted((max(s.start_ns, tl.t0), min(s.end_ns, tl.t1))
                   for s in trace.spans("restore.download")
                   if s.thread == main)
    spans = [(a, b) for a, b in spans if b > a]
    if not spans:
        return None
    idle = _idle_ns(spans, _busy(tl.device, tl.t0, tl.t1))
    return 100.0 * idle / (tl.t1 - tl.t0)
