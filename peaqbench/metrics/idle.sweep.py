"""Share of the traced window in which no operation ran on the device, %
(torch.profiler's device rows, their union against the window's length on
the host clock)."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
