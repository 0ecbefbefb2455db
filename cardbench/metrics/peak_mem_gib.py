"""GiB of device memory the program held at its peak over the measured
window (``torch.cuda.max_memory_allocated`` after a reset at its start)."""


def read(ctx):
    return ctx["window_peak_bytes"] / 2 ** 30
