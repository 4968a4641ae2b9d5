"""The whole training step's share of the card's peak, in %: the
step's operations (forward and backward, counted on the plain reference
at the cell's shapes) times the window's steps, over the window's
seconds and the peak of the configuration's dtype."""

from portbench.peaks import PEAK_FLOPS


def read(ctx):
    if not ctx.get("steps") or not ctx.get("window_s"):
        return None
    peak = PEAK_FLOPS[ctx["dtype"]]
    return 100.0 * ctx["flops_per_step"] * ctx["steps"] / ctx["window_s"] \
        / peak
