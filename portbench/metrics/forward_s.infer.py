"""Seconds a volume of the block engine's forward: per axis, from the
axis's start to its last block dispatched and handed to the matcher
(``run_inference3d``'s ``stats["axes"][a]["forward_seconds"]``), summed
over the axes, the mean over the window's volumes."""


def read(ctx):
    return ctx.get("forward_s") if ctx.get("volumes") else None
