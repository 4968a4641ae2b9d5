"""Seconds a volume of the host tail after each axis's forward: the
matcher's drain, the backward matching, the tracking and the filters
(``stats["axes"][a]["seconds"] - ["forward_seconds"]``), summed over the
axes, the mean over the window's volumes."""


def read(ctx):
    return ctx.get("host_tail_s") if ctx.get("volumes") else None
