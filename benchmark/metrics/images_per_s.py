"""Images completed over the window, per second of the window."""


def read(ctx):
    return ctx.window.rate(ctx.unit_images)
