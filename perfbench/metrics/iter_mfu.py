"""iter_mfu: the whole iteration's share of the card's peak: the N spMTTKRPs'
least time (the bytes bound, which binds) over the traced window's all-in time per
iteration, in percent.  It still bounds a gain once a kernel is off the path."""


def read(run):
    from perfbench import roofline
    if run.device_events is None or run.iterations == 0:
        return None
    try:
        bound = roofline.iteration_bound_s(run.config["shape"], run.config["nnz"],
                                           run.config["rank"], run.device_name)
    except KeyError:
        return None
    return bound / (run.window_s / run.iterations) * 100
