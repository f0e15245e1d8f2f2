"""What the readers of the recurrent restore's spans share: the port's
spans of one name, the device time of the ops launched inside them, and
the device's idle time inside them.  Each returns None, without raising,
where the port records no such span."""
from __future__ import annotations

import bisect


def spans(name: str) -> list | None:
    """The port's spans ``name`` sorted by start, or None where the port
    has no span store or recorded none."""
    try:
        from realvsr_tpu_torch.utils import trace
    except ImportError:      # a port without its own spans
        return None
    found = sorted(trace.spans(name), key=lambda s: s.start_ns)
    return found or None


def device_ns_launched_in(tl, found) -> int:
    """Device nanoseconds of the ops whose launch lies inside one of
    ``found`` (by time alone: only the restore entry's thread launches
    while they are open)."""
    starts = [s.start_ns for s in found]
    inside = set()
    for corr, (t, _) in tl.launch.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= found[i].end_ns:
            inside.add(corr)
    return sum(e - s for s, e, _, corr in tl.device if corr in inside)


def idle_ns_in(tl, found) -> tuple[int, int]:
    """(nanoseconds of ``found``, inside the traced window, in which no
    device op ran; their nanoseconds inside the window)."""
    merged = []
    for s, e, _, _ in tl.device:          # sorted by start
        s, e = max(s, tl.t0), min(e, tl.t1)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    idle = total = i = 0
    for sp in found:
        a, b = max(sp.start_ns, tl.t0), min(sp.end_ns, tl.t1)
        if b <= a:
            continue
        total += b - a
        while i < len(merged) and merged[i][1] <= a:
            i += 1
        t, j = a, i
        while j < len(merged) and merged[j][0] < b:
            idle += max(0, merged[j][0] - t)
            t = max(t, merged[j][1])
            j += 1
        idle += max(0, b - t)
    return idle, total


def per_frame_ms(r, name: str) -> float | None:
    """Device milliseconds a frame of the ops launched inside the spans
    ``name``, over the frames of the clips whose ``restore.flow`` span
    (attribute ``frames``) the window holds."""
    if r.timeline is None:
        return None
    found, clips = spans(name), spans("restore.flow")
    if found is None or clips is None:
        return None
    frames = sum(s.attrs.get("frames", 0) for s in clips)
    if frames == 0:
        return None
    return 1e-6 * device_ns_launched_in(r.timeline, found) / frames
