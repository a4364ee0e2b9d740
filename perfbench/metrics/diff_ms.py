"""diff_ms: mean duration of the program's `cp_als.diff` spans in the window, per
iteration: `avg_abs_diff`'s reconstruction at the nonzeros and its host readout."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "cp_als.diff")
