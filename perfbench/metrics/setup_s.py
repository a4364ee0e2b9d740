"""setup_s: process start to the first timed call: making the tensor, the plan, the
engine build, kernel builds or loads, and one warm decomposition."""


def read(run):
    return run.setup_s
