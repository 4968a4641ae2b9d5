"""The whole inference's share of the card's peak, in %: the forward
operations of every slice of every axis (counted on the plain reference
at the padded slice shapes) times the window's volumes, over the
window's seconds and the peak of the configuration's dtype."""

from portbench.peaks import PEAK_FLOPS


def read(ctx):
    if not ctx.get("volumes") or not ctx.get("window_s"):
        return None
    return 100.0 * ctx["flops_per_volume"] * ctx["volumes"] \
        / ctx["window_s"] / PEAK_FLOPS[ctx["dtype"]]
