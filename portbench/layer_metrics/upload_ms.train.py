"""Device milliseconds a step of the traced window spent in host-to-device
copies (the batch's upload), from the profiler's memcpy records."""


def read(r):
    if r.timeline is None or r.units == 0:
        return None
    ms = 1e3 * r.timeline.memcpy_s("Memcpy HtoD") / r.units
    return ms if ms > 0 else None
