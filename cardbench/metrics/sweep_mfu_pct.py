"""The whole sweep's share of the card's FP32 peak: the sweep's matrix
product operations, counted once from the plain reference at the cell's
shapes (``count_flops.py``, stored as ``flops_per_sweep`` in the cell's
file), over the mean sweep time of the measured window, at 67 TFLOP/s."""


def read(ctx):
    flops = ctx["cell"].get("flops_per_sweep")
    if not flops or ctx["sweep_s"] <= 0:
        return None
    return 100.0 * flops / (ctx["sweep_s"] * ctx["work"].FP32_FLOP_PER_S)
