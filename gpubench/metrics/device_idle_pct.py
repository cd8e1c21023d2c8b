"""The share of the profiled steps' host-clock window in which no
operation ran on the card (the union of its operations, the profiler's
"Buffer Flush" left out), averaged over the cards."""


def read(ctx):
    busy = sum(o["busy_s"] for o in ctx.others)
    window = sum(o["window_s"] for o in ctx.others)
    if busy <= 0 or window <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
