"""pressure_cg.roofline_pct (%): the least time of the pressure solves whose
iterations the run reports, at the chip's HBM bandwidth (each iteration: the
pressure operator's structural nonzeros read once, seven vectors of NNp
moved once), as a share of those solves' device time.  A step reports the
count of its last sub-iteration's solve only, so the share is taken over
each traced step's last solve: its count against its own kernels' time
(``MetricContext.last_solves``; a solve starts at a ``cg_solve`` or
``cg_init`` launch)."""

from benchmark.yardstick import PEAKS, cg_iteration_bytes

SOURCES = ("cg_solve", "cg_iter")
STARTS = ("cg_solve_kernel", "cg_init_kernel")


def read(ctx):
    solves = ctx.last_solves(STARTS, SOURCES)
    if not solves or not sum(ms for _, ms in solves):
        return None
    iters = sum(k for k, _ in solves)
    need_s = iters * cg_iteration_bytes(ctx.counts(), ctx.word) / PEAKS["hbm_bytes_per_s"]
    return 100.0 * need_s / (sum(ms for _, ms in solves) * 1e-3)
