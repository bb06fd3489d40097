"""95th percentile (nearest rank) of every frame due in the window, timed
from when it was due until its answer reached the host; a refused or failed
frame counts at the wait limit."""

import math


def read(run):
    lat = run.result.get("latencies_s")
    if lat is None or len(lat) == 0:
        return None
    ordered = sorted(float(x) for x in lat)
    return ordered[math.ceil(0.95 * len(ordered)) - 1] * 1e3
