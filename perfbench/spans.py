"""What the metric readers take from the program's spans in a traced run."""


def mean_ms(run, name: str) -> float | None:
    """Mean duration, in ms, of the spans called `name` inside the window; None
    when the run was not traced or the program emitted no such span."""
    if not run.spans:
        return None
    t0, t1 = run.window
    d = [b - a for n, a, b in run.spans if n == name and t0 <= a and b <= t1]
    return sum(d) / len(d) * 1e3 if d else None
