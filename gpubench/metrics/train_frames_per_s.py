"""Every frame trained in the window over the window's host-clock time:
the global batch times the window's steps, over the seconds from the
window's start to the synchronize after its last step."""


def read(ctx):
    run = ctx.run
    if not run.steps or run.window_s <= 0:
        return None
    return ctx.global_batch * run.steps / run.window_s
