"""Device ms per microbatch: every device operation of the traced window
(kernels, copies, fills), summed, over its microbatches."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return run.trace.device_ms()
