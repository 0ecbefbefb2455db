"""The share of a scan's roofline: the least time one H100 needs for the
scans a sweep makes of this kind (one forward and one backward, each at the
cell's (T, size, lanes); ``work.scan_work`` and ``work.bound_ms``) over the
device time a sweep of every kernel of that scan's group, whatever its
route (fix-up and folded kernels too).  Nothing to read where the group ran
no kernel."""


def read(ctx, group):
    spent = sum(b - a for name, a, b in ctx["kernels"] if ctx["work"].group_of(name) == group)
    shape = ctx["scans"].get(group)
    if spent <= 0 or shape is None:
        return None
    work = ctx["work"]
    bound_s = 2 * work.bound_ms(*work.scan_work(group, *shape))[0] / 1e3
    return 100.0 * bound_s / (spent / ctx["sweeps"])
