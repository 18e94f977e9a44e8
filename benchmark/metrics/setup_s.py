"""Seconds from the process start to the first timed unit: imports,
weights, inputs, builds and warm-up."""


def read(ctx):
    return ctx.setup_s
