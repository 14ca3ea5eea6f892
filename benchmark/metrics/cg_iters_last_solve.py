"""cg_iters_last_solve (it/solve): the pressure CG iterations of each step's
last solve, as the step reports them (``StepStats.cg_iters``: the explicit
step reports its last sub-iteration's solve only)."""


def read(ctx):
    return sum(r["cg_iters"] for r in ctx.rows) / ctx.steps
