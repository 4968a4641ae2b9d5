"""The grouping kernel's (K1, ``group_pixels``) share of its roofline, in
%: the bytes its real slices need (centers, flags, offsets in, ids out;
``drivers.volume.k1_bytes``) at 3.35 TB/s, over the kernel's device time
in the trace. None where the trace holds no such kernel."""

from portbench.peaks import PEAK_BYTES


def read(ctx):
    t = ctx.get("k1_device_s")
    if not t or not ctx.get("volumes"):
        return None
    return 100.0 * ctx["k1_bytes_per_volume"] * ctx["volumes"] \
        / PEAK_BYTES / t
