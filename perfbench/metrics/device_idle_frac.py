"""device_idle_frac: the share of the traced window in which no operation ran on
the card."""


def read(run):
    from perfbench import devtrace
    if not run.device_events:
        return None
    busy = devtrace.busy_intervals(run.device_events, *run.window)
    return 1.0 - sum(b - a for a, b in busy) / run.window_s
