"""pressure_cg.device_ms_per_step (ms/step): device time of the pressure CG's
kernels (those defined in csrc/cg_solve.cu and csrc/cg_iter.cu) a step."""

SOURCES = ("cg_solve", "cg_iter")


def read(ctx):
    ms = ctx.kernel_ms(SOURCES)
    return None if ms is None else ms / ctx.steps
