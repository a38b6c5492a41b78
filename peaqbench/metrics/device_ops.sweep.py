"""Device operations per microbatch in the traced window (kernels, copies
and fills, counted), over its microbatches."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.ops) / run.trace.microbatches
