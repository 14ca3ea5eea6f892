"""stencil.roofline_pct (%): the least time of a step's structured operator
products at the chip's HBM bandwidth (``yardstick.stencil_step_bytes``, with
the sub-iteration count each step reports) as a share of the
device time of the kernels defined in csrc/parity_apply.cu,
csrc/div_compact.cu and csrc/window_stencil.cu."""

from benchmark.yardstick import PEAKS, stencil_step_bytes

SOURCES = ("parity_apply", "div_compact", "window_stencil")


def read(ctx):
    ms = ctx.kernel_ms(SOURCES)
    if not ms:
        return None
    counts = ctx.counts()
    need = sum(stencil_step_bytes(counts, ctx.word, int(r["iters"])) for r in ctx.rows)
    return 100.0 * need / PEAKS["hbm_bytes_per_s"] / (ms * 1e-3)
