"""Seconds a volume of the cross-axis consensus
(``stats["consensus_seconds"]``), the mean over the window's volumes."""


def read(ctx):
    return ctx.get("consensus_s") if ctx.get("volumes") else None
