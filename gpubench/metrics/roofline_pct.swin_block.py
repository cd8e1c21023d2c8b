"""K2 and K3's share of their roofline on rank 0: the sum of every
launch's bound over a step's segmenter forwards (`kernels/swin_block.py`,
at the configuration's precision; the forwards a step from the port's
launch counter) over the device time of their kernels in the profile."""

from gpubench import trace
from gpubench.kernels import swin_block
from gpubench.peaks import PEAK_FLOPS


def read(ctx):
    seg = ctx.cell.config.get("segmenter")
    t = ctx.run.trace
    seconds, n = trace.device_s(t, swin_block.KERNEL_NAMES)
    k2 = ctx.run.launches.get("swin_attn_fused", 0)
    if not seg or not n or not k2:
        return None
    cfg = ctx.cell.config["port_config"]
    bf16 = seg.get("bf16_backbone", False)
    forward_s, launches = swin_block.forward_bound_s(
        cfg["batch_size"], cfg["height"], cfg["width"],
        PEAK_FLOPS["bfloat16" if bf16 else "float32"], seg["swin_size"],
        2 if bf16 else 4)
    forwards = k2 * t.steps / (launches // 2)
    return 100.0 * forward_s * forwards / seconds
