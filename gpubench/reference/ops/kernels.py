"""The port's CUDA kernels as their plain PyTorch versions, for the
reference: K1's plane sweep (`plane_sweep_cost_volume_kernel`, one process,
no depth split), K2 and K3 (`swin_attn_fused`, `swin_mlp_fused`), K4
(`window_attention`) and K5 (`ms_deform_attn_core`), each under the name
of the wrapper that the copied modules call. Copied from the port's
`ops/cuda/*.py` plain versions, with the kernels' rounding points."""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.ops import cost_volume
from gpubench.reference.ops.cost_volume import plane_sweep_terms
from gpubench.reference.ops.interp import grid_sample

Tensor = torch.Tensor

HEAD_DIM = 32


def relative_position_index(ws: int) -> np.ndarray:
    """(N, N) index into the ((2ws-1)^2, heads) bias table for query i and
    key j (`mal_tpu/segment/swin.py:45-50`)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0) + (ws - 1)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).astype(np.int64)


def window_attention_reference(qkv: Tensor, table: Tensor, mask: Tensor | None,
                               num_heads: int) -> Tensor:
    """softmax(q k^T d^-1/2 + bias + mask[w % nm]) v per window and head,
    plain torch.

    qkv (nW, N, 3C) from the qkv projection; table ((2ws-1)^2, heads);
    mask (nm, N, N), symmetric, or None. Returns (nW, N, C).
    """
    nW, N, C3 = qkv.shape
    C = C3 // 3
    h = num_heads
    d = C // h
    ws = int(round(N ** 0.5))
    q, k, v = qkv.reshape(nW, N, 3, h, d).unbind(2)          # (nW, N, h, d)
    idx = torch.from_numpy(relative_position_index(ws)).to(table.device)
    bias = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)

    attn = torch.einsum("wnhd,wmhd->whnm", q * d ** -0.5, k) + bias[None]
    if mask is not None:
        nm = mask.shape[0]
        attn = (attn.reshape(nW // nm, nm, h, N, N)
                + mask[None, :, None]).reshape(nW, h, N, N)
    attn = attn.softmax(dim=-1)
    return torch.einsum("whnm,wmhd->wnhd", attn, v).reshape(nW, N, C)


LN_EPS = 1e-6      # flax.linen.LayerNorm's default, which mal_tpu keeps


def _rounded(x: Tensor, dtype: torch.dtype) -> Tensor:
    """x rounded to `dtype`, back in fp32: products of such tensors
    accumulate in fp32, as the kernels' do (a bf16 matmul on the CPU would
    round its result)."""
    return x.to(dtype).to(torch.float32)


def _layernorm(x: Tensor, scale: Tensor, bias: Tensor) -> Tensor:
    """fp32 LayerNorm over the last axis, two passes, eps 1e-6."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + LN_EPS) * scale + bias


def swin_attn_reference(xr: Tensor, valid: Tensor, ln_scale: Tensor,
                        ln_bias: Tensor, wqkv: Tensor, bqkv: Tensor,
                        table: Tensor, mask: Tensor | None, wproj: Tensor,
                        bproj: Tensor, *, window_size: int, num_heads: int,
                        compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """K2 in plain torch.

    xr (B, Hp, Wp, C): the residual stream, padded to window multiples and
    rolled; valid (Hp, Wp): 1 on real tokens, 0 on pad tokens, rolled alike;
    wqkv (3C, C), bqkv (3C), wproj (C, C), bproj (C); table ((2ws-1)^2,
    heads); mask (nm, N, N) symmetric, or None. Returns the attention
    output (B, Hp, Wp, C) in xr's type, still padded and rolled.
    """
    B, Hp, Wp, C = xr.shape
    ws, h, dt = window_size, num_heads, compute_dtype
    N, d = ws * ws, C // num_heads
    y = _layernorm(xr.to(torch.float32), ln_scale, ln_bias)
    y = _rounded(y * valid[None, :, :, None], dt)
    wins = (y.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
            .permute(0, 1, 3, 2, 4, 5).reshape(-1, N, C))
    nW = wins.shape[0]
    qkv = _rounded(wins @ _rounded(wqkv, dt).T + bqkv, dt)
    q, k, v = qkv.reshape(nW, N, 3, h, d).unbind(2)           # (nW, N, h, d)
    idx = torch.from_numpy(relative_position_index(ws)).to(table.device)
    bias = table[idx.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)[None]
    if mask is not None:
        bias = bias + mask[:, None]                          # (nm, h, N, N)
    nm = bias.shape[0]
    s = torch.einsum("wnhd,wmhd->whnm", q, k) * d ** -0.5
    s = (s.reshape(nW // nm, nm, h, N, N) + bias).reshape(nW, h, N, N)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = _rounded(e / e.sum(dim=-1, keepdim=True), dt)
    attn = _rounded(torch.einsum("whnm,wmhd->wnhd", p, v).reshape(nW, N, C), dt)
    out = attn @ _rounded(wproj, dt).T + bproj
    out = (out.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
           .permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C))
    return out.to(xr.dtype)


def swin_mlp_reference(x: Tensor, ln_scale: Tensor, ln_bias: Tensor,
                       w1: Tensor, b1: Tensor, w2: Tensor, b2: Tensor, *,
                       compute_dtype: torch.dtype = torch.float32) -> Tensor:
    """K3 in plain torch: x (tokens, C), w1 (hidden, C), w2 (C, hidden).
    Returns x + MLP(LN(x)) in x's type."""
    dt = compute_dtype
    xf = x.to(torch.float32)
    y = _rounded(_layernorm(xf, ln_scale, ln_bias), dt)
    hid = y @ _rounded(w1, dt).T + b1
    hid = _rounded(0.5 * hid * (1.0 + torch.erf(hid * 2.0 ** -0.5)), dt)
    return (xf + (hid @ _rounded(w2, dt).T + b2)).to(x.dtype)


def _plane_sweep_reference(cur: Tensor, lookup: Tensor, M: Tensor, t: Tensor,
                           depth_bins: Tensor, chunk: int,
                           occ: Tensor | None = None,
                           apply_occ: Tensor | None = None,
                           pool_th: float = 0.0) -> Tensor:
    """K1's plain version, and with `occ` given K6's."""
    BF, h, w, C = cur.shape
    D = depth_bins.shape[0]
    if D % chunk:
        raise ValueError(f"num_depth_bins {D} must be divisible by chunk {chunk}")
    dev = cur.device
    u = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, 1, w)
    v = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, 1, h, 1)
    m = M.reshape(BF, 9, 1, 1, 1)
    tt = t.reshape(BF, 3, 1, 1, 1)
    ax = m[:, 0] * u + m[:, 1] * v + m[:, 2]               # (BF, 1, h, w)
    ay = m[:, 3] * u + m[:, 4] * v + m[:, 5]
    az = m[:, 6] * u + m[:, 7] * v + m[:, 8]
    inner = (u >= 2) & (u <= w - 3) & (v >= 2) & (v <= h - 3)

    flat = lookup.reshape(BF * h * w, C)
    base = (torch.arange(BF, device=dev) * (h * w)).reshape(BF, 1, 1, 1)
    if occ is not None:
        occ_flat = occ.reshape(BF * h * w, 1)
        applied = (apply_occ > 0).reshape(BF, 1, 1, 1)
    out = []
    for d in depth_bins.to(torch.float32).reshape(D // chunk, chunk):
        d = d.reshape(1, chunk, 1, 1)
        xh = d * ax + tt[:, 0]
        yh = d * ay + tt[:, 1]
        zh = d * az + tt[:, 2]
        x = xh / (zh + 1e-7)
        y = yh / (zh + 1e-7)

        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx1 = x - x0
        wx0 = 1.0 - wx1
        wy1 = y - y0
        wy0 = 1.0 - wy1

        def warp(values, channels):
            """Zeros-padded bilinear warp of (BF * h * w, channels) values,
            the corners summed in the kernel's order."""
            total = 0.0
            for xi, yi, wgt in ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
                                (x0, y0 + 1, wx0 * wy1),
                                (x0 + 1, y0 + 1, wx1 * wy1)):
                ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
                idx = (yi.clamp(0, h - 1).long() * w
                       + xi.clamp(0, w - 1).long() + base)
                vals = values.index_select(0, idx.reshape(-1))
                total = total + (vals.reshape(idx.shape + (channels,))
                                 * (wgt * ok)[..., None])
            return total

        warped = warp(flat, C)                              # (BF, chunk, h, w, C)
        if occ is not None:
            # cv_set_1: an occluded sample is held against all-ones features
            omask = (warp(occ_flat, 1)[..., 0] > pool_th) & applied
            warped = torch.where(omask[..., None], 1.0, warped)
        diff = (warped - cur[:, None]).abs().mean(dim=-1)   # (BF, chunk, h, w)
        edge = (x >= 2.0) & (x <= w - 2) & (y >= 2.0) & (y <= h - 2)
        out.append(diff * (edge & inner).to(diff.dtype))
    return torch.cat(out, dim=1)


def _frame_mean_cost(cur_feats: Tensor, lookup_feats: Tensor,
                     rel_poses: Tensor, K: Tensor, inv_K: Tensor,
                     depth_bins: Tensor) -> Tensor:
    """The cost of each plane of `depth_bins` (B, D, h, w) before the
    missing fill: K1's per-frame differences, valid frames only, summed
    over the frames and divided by the count of frames that saw it."""
    B, h, w, C = cur_feats.shape
    F = lookup_feats.shape[1]
    D = depth_bins.shape[0]

    M, t = plane_sweep_terms(rel_poses, K, inv_K)
    cur_rep = cur_feats[:, None].expand(B, F, h, w, C).reshape(B * F, h, w, C)
    diffs = plane_sweep_diffs(cur_rep.contiguous(),
                              lookup_feats.reshape(B * F, h, w, C).contiguous(),
                              M.reshape(B * F, 3, 3).contiguous(),
                              t.reshape(B * F, 3).contiguous(),
                              depth_bins.to(torch.float32).contiguous())
    diffs = diffs.reshape(B, F, D, h, w)

    valid = rel_poses.abs().sum(dim=(-1, -2)) != 0
    diffs = diffs * valid[:, :, None, None, None].to(diffs.dtype)

    cost = diffs.sum(dim=1)
    counts = (diffs > 0).to(diffs.dtype).sum(dim=1)
    return cost / (counts + 1e-7)


def ms_deform_attn_core_per_level(value: Tensor,
                                  spatial_shapes: list[tuple[int, int]],
                                  sampling_locations: Tensor,
                                  attention_weights: Tensor) -> Tensor:
    """Deformable sampling, plain torch.

    value (B, sum(HW), heads, ch); sampling_locations (B, Lq, heads, L, P, 2)
    as (x, y) in [0, 1]; attention_weights (B, Lq, heads, L, P). Returns
    (B, Lq, heads * ch): per level, a bilinear sample with zeros padding
    and align_corners=False, weighted and summed over levels and points.
    """
    B, _, H_, C = value.shape
    _, Lq, _, L, P, _ = sampling_locations.shape
    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    out = 0.0
    for lvl, (h, w) in enumerate(spatial_shapes):
        # heads fold into the batch: each head samples its own value slice
        v = values[lvl].reshape(B, h, w, H_, C).permute(0, 3, 4, 1, 2)
        v = v.reshape(B * H_, C, h, w)
        g = 2.0 * sampling_locations[:, :, :, lvl] - 1.0   # (B, Lq, H_, P, 2)
        g = g.permute(0, 2, 1, 3, 4).reshape(B * H_, Lq, P, 2)
        sampled = grid_sample(v, g, padding_mode="zeros", align_corners=False)
        sampled = sampled.reshape(B, H_, C, Lq, P)
        w_l = attention_weights[:, :, :, lvl]              # (B, Lq, H_, P)
        out = out + torch.einsum("bhclp,blhp->blhc", sampled, w_l)
    return out.reshape(B, Lq, H_ * C)




def plane_sweep_diffs(cur: Tensor, lookup: Tensor, M: Tensor, t: Tensor,
                      depth_bins: Tensor) -> Tensor:
    """K1: per-frame masked L1 plane-sweep differences (BF, D, h, w)."""
    D = depth_bins.shape[0]
    chunk = max(c for c in range(1, min(D, 16) + 1) if D % c == 0)
    return _plane_sweep_reference(cur, lookup, M, t, depth_bins, chunk)


def plane_sweep_cost_volume_kernel(cur_feats: Tensor, lookup_feats: Tensor,
                                   rel_poses: Tensor, K: Tensor, inv_K: Tensor,
                                   depth_bins: Tensor):
    """(cost_volume, missing_mask), each (B, D, h, w), in one process."""
    return cost_volume.fill_missing(_frame_mean_cost(
        cur_feats, lookup_feats, rel_poses, K, inv_K, depth_bins))


swin_attn_fused = swin_attn_reference
swin_mlp_fused = swin_mlp_reference
window_attention = window_attention_reference
ms_deform_attn_core = ms_deform_attn_core_per_level
