"""Device ms per microbatch of the fft ear layer: the traced window's
operations that the kernel table (peaqbench/kernels/) gives to it."""


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.layer_ms("fft_ear")
    return ms if ms > 0 else None
