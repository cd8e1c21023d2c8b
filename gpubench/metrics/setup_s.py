"""Seconds from the process's start to the window's start: imports, the
kernels loaded from their cache (or built), the models and their weights,
the pool of batches and the compared steps, which warm up every shape."""


def read(ctx):
    return ctx.run.setup_s
