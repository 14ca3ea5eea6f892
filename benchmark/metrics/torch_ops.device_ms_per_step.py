"""torch_ops.device_ms_per_step (ms/step): device time a step of every
device event that is no kernel of the port's csrc/ (PyTorch's own kernels,
library kernels, copies and sets)."""


def read(ctx):
    return ctx.other_ms() / ctx.steps
