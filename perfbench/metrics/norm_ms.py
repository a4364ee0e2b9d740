"""norm_ms: mean duration of the program's `cp_als.norm` spans in the window, per
iteration: the fit's host norm of the tensor's values (a float64 copy and its norm),
a part of `fit_ms`."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "cp_als.norm")
