"""K2 and K3, the fused halves of a Swin block
(`mal_tpu_torch/csrc/swin_block.cu`): their operations and bytes at a
stage's shapes, copied frozen from `chip_smoke.py:k2_phase` / `k3_phase`,
summed over one segmenter forward's blocks, and the names of the device
functions the two launch (every `__global__` of that file)."""

from __future__ import annotations

from gpubench.peaks import bound_s

KERNEL_NAMES = ("layernorm_rows_kernel", "cast_bf16_kernel", "gemm_tma_kernel",
                "mlp_fused_kernel", "gemm_f32_kernel", "window_core_kernel",
                "window_core_mma_kernel")
HEAD_DIM = 32
# size -> embed_dim, blocks a stage, heads a stage, window (Swin's configs)
SWIN = {"tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7),
        "large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12)}


def attn_counts(B: int, Hp: int, Wp: int, C: int, heads: int, ws: int,
                shifted: bool, stream_bytes: int) -> tuple[float, float]:
    """K2 on a (B, Hp, Wp, C) padded map: the stream read and written once,
    the parameters, `valid`, the table and the mask read once; the qkv and
    proj products, q k^T and p v a window and head, ~5 operations a score
    for the softmax."""
    N = ws * ws
    M = B * Hp * Wp
    nW = M // N
    params = (2 * C + 3 * C * C + 3 * C + (2 * ws - 1) ** 2 * heads
              + C * C + C + Hp * Wp
              + ((Hp // ws) * (Wp // ws) * N * N if shifted else 0))
    n_bytes = 2 * M * C * stream_bytes + 4 * params
    n_ops = 2 * M * C * 4 * C + nW * heads * (4 * N * N * HEAD_DIM + 5 * N * N)
    return float(n_bytes), float(n_ops)


def mlp_counts(tokens: int, C: int, stream_bytes: int) -> tuple[float, float]:
    """K3 on (tokens, C): the stream in and out once, the parameters once;
    the two products and ~10 operations a hidden unit for the GELU."""
    n_bytes = 2 * tokens * C * stream_bytes + 4 * (2 * C + 8 * C * C + 5 * C)
    n_ops = 2 * tokens * C * 4 * C * 2 + 10 * tokens * 4 * C
    return float(n_bytes), float(n_ops)


def forward_bound_s(B: int, H: int, W: int, peak_flops: float,
                    size: str = "large", stream_bytes: int = 2
                    ) -> tuple[float, int]:
    """(the sum of each launch's bound in seconds, launches of K2 + K3) of
    one segmenter forward on (B, H, W) images: the patch embedding takes
    the map to H/4 x W/4, each stage halves it, pads it to window
    multiples and shifts its odd blocks where both padded sides exceed a
    window (`segment/swin.py`)."""
    embed, depths, heads, ws = SWIN[size]
    h, w = H // 4, W // 4
    total, launches = 0.0, 0
    for s in range(4):
        C = embed * 2 ** s
        Hp, Wp = -(-h // ws) * ws, -(-w // ws) * ws
        shiftable = min(Hp, Wp) > ws
        for b in range(depths[s]):
            total += bound_s(*attn_counts(B, Hp, Wp, C, heads[s], ws,
                                          shiftable and b % 2 == 1,
                                          stream_bytes), peak_flops)
            total += bound_s(*mlp_counts(B * h * w, C, stream_bytes),
                             peak_flops)
            launches += 2
        h, w = -(-h // 2), -(-w // 2)
    return total, launches
