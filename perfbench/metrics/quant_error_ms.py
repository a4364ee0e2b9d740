"""quant_error_ms: mean duration of the program's `cp_als.quant_error` spans in the
window, per call: a lossy engine's measured MTTKRP error (the float COO MTTKRP of the
last mode and its host readout).  Float engines emit no such span."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "cp_als.quant_error")
