"""Device kernels a sweep: every kernel in the trace of the traced sweeps
(copies and fills left out), over the sweeps.  The host's dispatch cost
grows with it."""


def read(ctx):
    if not ctx["kernels"]:
        return None
    return len(ctx["kernels"]) / ctx["sweeps"]
