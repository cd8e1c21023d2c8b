"""The whole step's share of the cards' peak: the model FLOPs of the
global batch (the configuration file's count a frame, made once by
`tools/count_flops.py` over the plain reference) times the unprofiled
steps of the traced window, over their host-clock seconds, over the peak
of the configuration's precision times the cards."""

from gpubench.peaks import PEAK_FLOPS


def read(ctx):
    per_frame = ctx.cell.config.get("model_flops_per_frame")
    run = ctx.run
    if not per_frame or not run.unprofiled_steps or run.unprofiled_s <= 0:
        return None
    rate = per_frame * ctx.global_batch * run.unprofiled_steps / run.unprofiled_s
    peak = PEAK_FLOPS[ctx.cell.config["precision"]] * ctx.cell.chips
    return 100.0 * rate / peak
