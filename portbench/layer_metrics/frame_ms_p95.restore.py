"""95th percentile, in ms, over every frame of the traced window, of the
time from asking the restore iterator for a frame to holding its float32
output (host clock, the benchmark's loop; a clip's first frame includes
the clip's upload)."""
import numpy as np


def read(r):
    lat = r.host_spans.get("frame")
    return 1e3 * float(np.percentile(lat, 95)) if lat else None
