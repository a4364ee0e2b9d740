"""iter_ms: the window's wall time over the CP-ALS iterations completed in it.

Every decomposition started in the window is counted to its end, so this is all the
work over all the time: the mode updates, each iteration's fit and difference, and
each call's factor draw and tensor upload."""


def read(run):
    if run.iterations == 0:
        return None
    return run.window_s / run.iterations * 1e3
