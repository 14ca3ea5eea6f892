"""sub_iters_per_step (it/step): the explicit step's nonlinear
sub-iterations (``StepStats.iters``), each one pressure solve."""


def read(ctx):
    return sum(r["iters"] for r in ctx.rows) / ctx.steps
