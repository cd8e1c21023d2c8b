#!/usr/bin/env python3
"""What holds K4's w7 kernel: its device time with parts taken out.

    python3 tools/ablate_w7.py

Builds variants of `mal_tpu_torch/csrc/window_attention.cu` (a copy with a
loop's trip count set to 0, or the attention call skipped) into a
temporary directory and times each variant's `window_attention_w7_f32` at
MaskFormer v1's four Swin-T stages (batch 2 at 256x448, masked), by the
device time torch.profiler reports (`chip_smoke._sub_kernel_ms`, 20
calls). The variants without a part give wrong outputs by design: what they
show is the time of what is left.

- full: the kernel as built for the port;
- no_pv: without p v (the loop over keys in fours);
- no_qk: without q k^T (the loop over channels in fours);
- no_products: without either: staging, mask bits, bias, softmax, stores;
- staging_only: the pair loop without the attention: cp.async of q, k, v
  and the bias column, and the mask bits;
- no_exp: the softmax's expf replaced by its argument;
- blocks_1, blocks_2: the whole kernel on a persistent grid of 1 or 2
  blocks an SM (the port's takes as many as fit, 4);
- block_a_pair: the whole kernel, one block a pair (no persistent grid).

Needs a CUDA device and nvcc; prints the card and one line a stage.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_PV = "for (int t = 0; t < kPv7 / 4; ++t)"
_QK = "for (int g = 0; g < kD / 4; ++g) {\n    float4 qv[4], kv[7];"
_GRID = "window_attention_w7_kernel<<<std::min(pairs, sms * per_sm),"
VARIANTS = {
    "full": [],
    "no_pv": [(_PV, "for (int t = 0; t < 0; ++t)")],
    "no_qk": [(_QK, _QK.replace("g < kD / 4", "g < 0"))],
    "no_products": [(_PV, "for (int t = 0; t < 0; ++t)"),
                    (_QK, _QK.replace("g < kD / 4", "g < 0"))],
    "staging_only": [("    attend7(sm, sm.stage[slot], mask != nullptr,",
                      "    if (scale < 0.f) attend7(sm, sm.stage[slot], "
                      "mask != nullptr,")],
    "no_exp": [("s[a][c] = expf(s[a][c] - mx);", "s[a][c] = s[a][c] - mx;")],
    "blocks_1": [(_GRID, _GRID.replace("sms * per_sm", "sms * 1"))],
    "blocks_2": [(_GRID, _GRID.replace("sms * per_sm", "sms * 2"))],
    "block_a_pair": [(_GRID, _GRID.replace("std::min(pairs, sms * per_sm)",
                                           "pairs"))],
}


def build_variants(tmp: str) -> dict:
    from mal_tpu_torch.ops.cuda import build

    src = (build.SOURCE_DIR / "window_attention.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the "
                                   "source any more")
            text = text.replace(old, new)
        cu, so = os.path.join(tmp, f"{name}.cu"), os.path.join(tmp, f"{name}.so")
        with open(cu, "w") as f:
            f.write(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.SOURCE_DIR),
               "-o", so, cu]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    fns = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(so).window_attention_w7_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    import chip_smoke as cs
    from mal_tpu_torch.segment.swin import shift_mask

    if not torch.cuda.is_available():
        print("ablate_w7: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    with tempfile.TemporaryDirectory() as tmp:
        fns = build_variants(tmp)
        for stage, ((Hp, Wp), _, C, heads, _) in cs.SWIN_T_STAGES.items():
            nm = (Hp // 7) * (Wp // 7)
            nW = cs.V1_BATCH * nm
            g = torch.Generator(device="cuda").manual_seed(stage)
            qkv = torch.randn((nW, 49, 3 * C), generator=g, device="cuda")
            table = 0.02 * torch.randn((169, heads), generator=g,
                                       device="cuda")
            mask = shift_mask(Hp, Wp, 7, 3, "cuda")
            out = torch.empty((nW, 49, C), device="cuda")
            times = []
            for name, fn in fns.items():
                def call(fn=fn):
                    err = fn(qkv.data_ptr(), table.data_ptr(),
                             mask.data_ptr(), out.data_ptr(), nW, heads, 7,
                             nm, torch.cuda.current_device(),
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: launch failed ({err})")
                ms = sum(t for _, t in cs._sub_kernel_ms(call, reps=20))
                times.append(f"{name} {ms:.4f}")
            print(f"w7 Swin-T stage {stage} (nW={nW}, heads={heads}), device "
                  f"ms a call: " + "; ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
