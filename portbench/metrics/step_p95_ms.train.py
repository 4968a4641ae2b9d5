"""95th percentile of the device time between the ends of consecutive
training steps in the window, in ms (CUDA events recorded after each
step of the traced run)."""

import statistics


def read(ctx):
    ms = ctx.get("step_ms") or []
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
