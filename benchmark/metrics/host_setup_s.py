"""host_setup_s (s): the wall of the solver's constructor (the host set-up
through the setup cache and the upload of its tables)."""


def read(ctx):
    return ctx.host_setup_s
