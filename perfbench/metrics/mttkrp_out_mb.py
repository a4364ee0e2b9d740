"""mttkrp_out_mb: the bytes of the outputs the spMTTKRP kernel ops allocate per
iteration (their zero-filled (I_pad, R) buffers), in MB of 1e6 B, from the
program's counter `mttkrp.out_bytes` in `repro_torch.obs.metrics.default_registry`.

The program counts only while tracing is on, and the registry lives as long as the
process, so the reading stands only where the op calls it counted (`mttkrp.calls`)
are the window's: N for each of the window's `cp_als.iter` spans.  None otherwise,
as for a program without the counters."""
import sys

BYTES, CALLS, SPAN = "mttkrp.out_bytes", "mttkrp.calls", "cp_als.iter"


def read(run):
    metrics = sys.modules.get("repro_torch.obs.metrics")
    if not run.spans or metrics is None:
        return None
    snap = metrics.default_registry.snapshot()
    nbytes, calls = snap.get(BYTES), snap.get(CALLS)
    if not nbytes or not calls or not nbytes["value"]:
        return None
    t0, t1 = run.window
    iters = sum(1 for n, a, b in run.spans if n == SPAN and t0 <= a and b <= t1)
    if iters == 0 or calls["value"] != len(run.config["shape"]) * iters:
        return None
    return nbytes["value"] / iters / 1e6
