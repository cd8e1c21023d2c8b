"""The 90th percentile of the window's step periods, each read from the
CUDA events recorded on the stream at every step boundary (the host clock
on the CPU), rank 0's."""

from gpubench import train_cell


def read(ctx):
    if len(ctx.run.periods_ms) < 2:
        return None
    return train_cell.p90(ctx.run.periods_ms)
