"""Device ms per microbatch of every operation that no kernel-table file
claims: the MOVs' eager remainder, the accumulators, the MLP, casts and
copies."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return run.trace.layer_ms("eager")
