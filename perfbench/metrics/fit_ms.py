"""fit_ms: mean duration of the program's `cp_als.fit` spans in the window, per
iteration: the fit's host norm, Gram products and its one readout."""


def read(run):
    if not run.spans:
        return None
    t0, t1 = run.window
    d = [b - a for name, a, b in run.spans if name == "cp_als.fit" and t0 <= a and b <= t1]
    return sum(d) / len(d) * 1e3 if d else None
