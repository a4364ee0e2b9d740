"""engine_build_s: the harness's own timing of `build_engine` in set-up (chunking,
task packing, the upload of the chunked arrays)."""


def read(run):
    return run.engine_build_s
