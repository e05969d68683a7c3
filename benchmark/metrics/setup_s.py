"""Set-up seconds: process start to the window's opening synchronize
(kernel build or load, weights, pose pool, the first chunks)."""


def read(ctx):
    return ctx.setup_s
