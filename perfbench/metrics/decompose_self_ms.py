"""decompose_self_ms: per decomposition, the harness's span around the `cp_als`
call less the program's `cp_als.iter` and `cp_als.fit` spans inside it: factor
init, the COO upload, each iteration's difference and the quantisation error."""
import bisect


def read(run):
    if not run.spans:
        return None
    calls = sorted((a, b) for name, a, b in run.spans if name == "perfbench.decompose")
    if not calls:
        return None
    inner = sum(b - a for name, a, b in run.spans
                if name in ("cp_als.iter", "cp_als.fit")
                and (i := bisect.bisect_right(calls, (a, float("inf"))) - 1) >= 0
                and calls[i][1] >= b)
    return (sum(b - a for a, b in calls) - inner) / len(calls) * 1e3
