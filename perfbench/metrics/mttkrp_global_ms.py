"""mttkrp_global_ms: device time per iteration of the spMTTKRP kernels' `global`
tier (`global_kernel` in `kernels/csrc/mttkrp_tiles.cuh`, float and fixed point),
from the device trace, inside the program's `cp_als.iter` spans as `mttkrp_ms`
counts them.  None where no launch took that tier."""
import bisect
import re

PATTERN = re.compile(r"global_kernel")


def iteration_events(run):
    """(overlap seconds, event) of each `global_kernel` launch with the
    iteration spans inside the window; empty for an untraced run."""
    if not run.device_events or not run.spans or run.iterations == 0:
        return []
    t0, t1 = run.window
    iters = sorted((max(a, t0), min(b, t1)) for name, a, b in run.spans
                   if name == "cp_als.iter" and b > t0 and a < t1)
    starts = [a for a, _ in iters]
    out = []
    for ev in run.device_events:
        name, a, b = ev
        if not PATTERN.search(name):
            continue
        inside = 0.0
        k = bisect.bisect_left(starts, b) - 1
        while k >= 0 and iters[k][1] > a:
            inside += max(0.0, min(b, iters[k][1]) - max(a, iters[k][0]))
            k -= 1
        if inside > 0:
            out.append((inside, ev))
    return out


def read(run):
    busy = sum(s for s, _ in iteration_events(run))
    return busy / run.iterations * 1e3 if busy > 0 else None
