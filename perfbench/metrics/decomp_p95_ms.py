"""decomp_p95_ms: the 95th percentile (nearest rank) of the wall time of every
decomposition in the window, from the call to its return."""
import math


def read(run):
    times = sorted(e - s for s, e, _ in run.decomps)
    if not times:
        return None
    return times[math.ceil(0.95 * len(times)) - 1] * 1e3
