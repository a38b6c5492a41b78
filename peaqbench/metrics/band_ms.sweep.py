"""Device ms per microbatch of the recurrences and band epilogues (K1, K2,
L1, L2, M1): the traced window's operations that the kernel table gives to
the band layer."""


def read(run):
    if run.trace is None:
        return None
    ms = run.trace.layer_ms("band")
    return ms if ms > 0 else None
