"""mttkrp_global_roofline: the `global` tier's launches per iteration, each bounded
by one spMTTKRP's least time (`perfbench.roofline.bound_s` of `mttkrp_bytes` and
`mttkrp_flops`: the bytes are the same in every mode, so one bound per launch is
exact), over `mttkrp_global_ms`, in percent."""
from perfbench import roofline
from perfbench.metrics.mttkrp_global_ms import iteration_events


def read(run):
    # the launches and their device time, as the `mttkrp_global_ms` reader counts them
    events = iteration_events(run)
    if not events:
        return None
    ms = sum(s for s, _ in events) / run.iterations * 1e3
    shape, nnz, rank = run.config["shape"], run.config["nnz"], run.config["rank"]
    try:
        one = roofline.bound_s(roofline.mttkrp_bytes(shape, nnz, rank, 0),
                               roofline.mttkrp_flops(shape, nnz, rank), run.device_name)
    except KeyError:
        return None
    return len(events) / run.iterations * one * 1e3 / ms * 100
