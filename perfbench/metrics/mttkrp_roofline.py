"""mttkrp_roofline: the N spMTTKRPs' least time per iteration (the bytes bound of
`perfbench.roofline`, counted from the problem) over `mttkrp_ms`, in percent."""


def read(run):
    from perfbench import manifest, roofline
    ms = manifest.reader("mttkrp_ms")(run)
    if ms is None:
        return None
    try:
        bound = roofline.iteration_bound_s(run.config["shape"], run.config["nnz"],
                                           run.config["rank"], run.device_name)
    except KeyError:
        return None
    return bound * 1e3 / ms * 100
