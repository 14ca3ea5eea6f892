"""device_idle_pct (%): the share of the traced segments' host wall in which
no operation ran on the device (the union of the device spans)."""

from benchmark.trace import busy_share


def read(ctx):
    busy = busy_share(ctx.trace.device, ctx.trace.wall_us)
    return None if busy is None else 100.0 * (1.0 - busy)
