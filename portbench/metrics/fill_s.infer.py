"""Seconds a volume of ``fill_volume`` into the in-memory label array
(the harness's span around it), the mean over the window's volumes."""


def read(ctx):
    return ctx.get("fill_s") if ctx.get("volumes") else None
