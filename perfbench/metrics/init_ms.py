"""init_ms: mean duration of the program's `cp_als.init` spans in the window, per
call: the host draw of the initial factors and their float32 cast."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "cp_als.init")
