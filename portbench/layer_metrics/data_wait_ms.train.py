"""Mean milliseconds a step of the traced window waited in ``next()`` on
the Trainer's loader iterator (host clock, the benchmark's loop)."""


def read(r):
    waits = r.host_spans.get("loader_wait")
    return 1e3 * sum(waits) / len(waits) if waits else None
