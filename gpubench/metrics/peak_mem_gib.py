"""`torch.cuda.max_memory_allocated()` over set-up and window, after a
reset at the start, of the fullest card, in GiB."""

GIB = 2 ** 30


def read(ctx):
    return max(o["peak_bytes"] for o in ctx.others) / GIB
