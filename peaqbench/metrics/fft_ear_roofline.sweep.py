"""Share of its roofline of the fft ear layer, %: the least time of the
ear's work for one microbatch (peaqbench/roofline.py: its samples read
once, the patterns and per-frame MOV inputs it hands on written once, and
the FIR bank's operations in the FB ear, over the H100 SXM's published
peaks) over the layer's device ms per microbatch in the traced window."""


def read(run):
    if run.trace is None or "fft_ear" not in run.work:
        return None
    ms = run.trace.layer_ms("fft_ear")
    if ms <= 0:
        return None
    return 100.0 * run.work["fft_ear"][0] / ms
