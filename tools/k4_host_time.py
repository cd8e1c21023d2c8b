#!/usr/bin/env python3
"""K4's caller's time per call, for comparing two checkouts in one run.

    python3 tools/k4_host_time.py [--root DIR] [--label NAME]

Imports `mal_tpu_torch` from DIR (default: this checkout) and times its
`window_attention` at the four Swin-L stages (window 12: 192x640, batch
12) and the four Swin-T stages (window 7: MaskFormer v1, batch 2 at
256x448), masked where the stage shifts: 7 rounds of 50 back-to-back
calls, each round bracketed by CUDA events, the median and min-max of the
per-call time. Where the wrapper takes `route=`, the loop route is timed
too, so that the same kernel can be held against an older checkout whose
wrapper launched it at window 7. Run it on two checkouts in turns (A, B,
B, A) on one card to compare their host paths. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# stage -> (padded map, channels, heads, shifted); `chip_smoke.py`'s
# SWIN_L_STAGES and SWIN_T_STAGES
SWIN_L = {0: ((48, 168), 192, 6, True), 1: ((24, 84), 384, 12, True),
          2: ((12, 48), 768, 24, False), 3: ((12, 24), 1536, 48, False)}
SWIN_T = {0: ((70, 112), 96, 3, True), 1: ((35, 56), 192, 6, True),
          2: ((21, 28), 384, 12, True), 3: ((14, 14), 768, 24, True)}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=ROOT)
    parser.add_argument("--label", default="this checkout")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    from mal_tpu_torch.ops.cuda.window_attention import window_attention
    from mal_tpu_torch.segment.swin import shift_mask
    from mal_tpu_torch.utils.profiling import cuda_time_ms

    if not torch.cuda.is_available():
        print("k4_host_time: no CUDA device", file=sys.stderr)
        return 1
    routes = "route" in inspect.signature(window_attention).parameters
    for name, ws, images, stages in (("Swin-L", 12, 12, SWIN_L),
                                     ("Swin-T", 7, 2, SWIN_T)):
        for stage, ((Hp, Wp), C, heads, shifted) in stages.items():
            g = torch.Generator(device="cuda").manual_seed(stage)
            nW = images * (Hp // ws) * (Wp // ws)
            qkv = torch.randn((nW, ws * ws, 3 * C), generator=g,
                              device="cuda")
            table = torch.randn(((2 * ws - 1) ** 2, heads), generator=g,
                                device="cuda")
            mask = shift_mask(Hp, Wp, ws, ws // 2, "cuda") if shifted else None
            fns = {"default": lambda: window_attention(qkv, table, mask,
                                                       heads)}
            if routes:
                fns["loop"] = lambda: window_attention(qkv, table, mask,
                                                       heads, route="loop")
            times = {k: [] for k in fns}
            for _ in range(7):
                for k, fn in fns.items():
                    times[k].append(cuda_time_ms(fn, 50, warmup=1))
            print(f"{args.label}: {name} stage {stage} (nW={nW}, heads="
                  f"{heads}), caller's ms a call, median (min-max) of 7 x 50: "
                  + "; ".join(f"{k} {statistics.median(t):.4f} "
                              f"({min(t):.4f}-{max(t):.4f})"
                              for k, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
