"""upload_ms: mean duration of the program's `cp_als.upload` spans in the window,
per call: the initial factors' and the COO arrays' copies from pageable host memory
to the card, which the host waits for."""
from perfbench import spans


def read(run):
    return spans.mean_ms(run, "cp_als.upload")
