"""Device ms a sweep of every kernel that is not one of the port's scan
kernels (``work.SCAN_GROUPS``): the E- and M-steps' tensor algebra."""


def read(ctx):
    rest = [b - a for name, a, b in ctx["kernels"] if ctx["work"].group_of(name) is None]
    if not rest:
        return None
    return 1e3 * sum(rest) / ctx["sweeps"]
