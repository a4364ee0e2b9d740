"""upload_mb_per_call: the bytes each call copies to the card (the initial factors,
the coordinates and the values), in MB of 1e6 B, from the program's counter
`cp_als.upload_bytes` in `repro_torch.obs.metrics.default_registry`.

The program counts only while tracing is on, and the registry lives as long as the
process, so its value is one window's only if no traced call of an earlier window or
of set-up added to it.  The program's `cp_als.uploads` counts the calls that added
bytes, and the tracer, cleared when the run turns tracing on, holds one
`cp_als.upload` span for each call since then: the reading stands only where that
count equals the window's spans and its calls, and is None otherwise, as it is for a
program without the counters."""
import sys

BYTES, CALLS, SPAN = "cp_als.upload_bytes", "cp_als.uploads", "cp_als.upload"


def read(run):
    metrics = sys.modules.get("repro_torch.obs.metrics")
    if not run.spans or not run.decomps or metrics is None:
        return None
    snap = metrics.default_registry.snapshot()
    nbytes, calls = snap.get(BYTES), snap.get(CALLS)
    if not nbytes or not calls or not nbytes["value"]:
        return None
    t0, t1 = run.window
    spans = [(a, b) for n, a, b in run.spans if n == SPAN]
    in_window = sum(t0 <= a and b <= t1 for a, b in spans)
    if not calls["value"] == len(spans) == in_window == len(run.decomps):
        return None
    return nbytes["value"] / len(run.decomps) / 1e6
