"""mttkrp_ms: device time per iteration of the spMTTKRP kernels and of the op's
global sum (the `index_add_` of `kernels/ops.py::_reduce`), from the device trace.

Only device time inside the program's `cp_als.iter` spans counts.  Each iteration
ends in a device synchronisation inside its span, so the span holds all of its
mode updates' device work and nothing launched before it; what runs outside
(`quant_error`'s float COO MTTKRP after the last iteration, whose `index_add_`
matches the same names, and the fit's and difference's reconstructions) is
another layer's."""
import bisect
import re

#: The hand-written kernels (`mttkrp_tiles.cuh`: task_kernel, global_kernel, float
#: and fixed point) and torch's index_add kernels, which inside an iteration only
#: the op's sum launches.
PATTERN = re.compile(r"task_kernel|global_kernel|indexFunc|index_add")


def read(run):
    if not run.device_events or not run.spans or run.iterations == 0:
        return None
    t0, t1 = run.window
    iters = sorted((max(a, t0), min(b, t1)) for name, a, b in run.spans
                   if name == "cp_als.iter" and b > t0 and a < t1)
    starts = [a for a, _ in iters]
    busy = 0.0
    for name, a, b in run.device_events:
        if not PATTERN.search(name):
            continue
        # the iteration spans do not overlap: check the last one opened by `b`
        # and those before it that `a` still reaches
        k = bisect.bisect_left(starts, b) - 1
        while k >= 0 and iters[k][1] > a:
            busy += max(0.0, min(b, iters[k][1]) - max(a, iters[k][0]))
            k -= 1
    return busy / run.iterations * 1e3 if busy > 0 else None
