"""Kernels K1 and K6, the plane-sweep cost volume, as CUDA kernels for Hopper.

Counterpart of `mal_tpu.ops.pallas.cost_volume_kernel` (the Pallas TPU
kernels `plane_sweep_diffs_pallas` and `plane_sweep_diffs_occ_pallas`, and
the wrapper `plane_sweep_cost_volume_pallas`). Both kernels are one
templated kernel in `mal_tpu_torch/csrc/plane_sweep.cu`; its header says
what bounds them and how they are laid out.

- `plane_sweep_diffs` (K1) and `plane_sweep_diffs_occ` (K6, DynamicDepth's
  `cv_set_1` volume: warped features of occluded samples become 1.0): the
  kernels' wrappers. For CUDA tensors each checks them and launches its
  kernel, counting each launch in its `.launches`; for CPU tensors each
  returns its plain version. Neither falls back from the kernel to the
  plain version.
- `plane_sweep_diffs_reference` / `plane_sweep_diffs_occ_reference`: the
  plain PyTorch versions, in the kernel's order of operations.
- `plane_sweep_cost_volume_kernel`: the full cost volume around K1, or
  inside a depth row one rank's share of its planes, gathered;
  `plane_sweep_cost_share` is a rank's share alone.
- `plane_sweep_routes`: how many tiles the kernel takes by each of its
  routes (empty, staged in shared memory, direct from device memory), from
  the same projection on any device: the kernel decides this on the card.

`mal_tpu`'s `cv_mxu_precision` ("highest", or "default" in fast mode)
chooses how many bf16 passes the TPU's matrix unit spends on the Pallas
kernels' one-hot interpolation products
(`mal_tpu/ops/pallas/cost_volume_kernel.py:39-43`). The CUDA kernels gather
in fp32 and have no such product, so `Config.cv_mxu_precision` is accepted
and changes nothing here: K1 and K6 are exact in fast mode, where the TPU
kernels are approximate, and are fed the fp32 casts of the bf16 trunk's
features.
"""

from __future__ import annotations

import ctypes

import torch

from mal_tpu_torch.ops import cost_volume
from mal_tpu_torch.ops.cost_volume import plane_sweep_terms
from mal_tpu_torch.ops.cuda import refuse_grad

Tensor = torch.Tensor

SOURCE = "plane_sweep"
_MAX_CHANNELS = 256   # a warp holds at most 8 float4 groups of a pixel
# the kernel's tile and shared-memory budget (csrc/plane_sweep.cu: kPlanes,
# kPixels, kBoxBytes)
TILE_PLANES = 8
TILE_PIXELS = 32
BOX_BYTES = 40 * 1024
ROUTES = ("empty", "staged", "direct")


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


def plane_sweep_diffs_reference(cur: Tensor, lookup: Tensor, M: Tensor,
                                t: Tensor, depth_bins: Tensor,
                                chunk: int = 16) -> Tensor:
    """Per-frame masked L1 plane-sweep differences (BF, D, h, w), plain torch.

    cur / lookup (BF, h, w, C); M (BF, 3, 3); t (BF, 3); depth_bins (D,).
    The depth planes go `chunk` at a time (D % chunk == 0) to bound memory.
    The projection follows the kernels' order of operations,
    x = (d * ((m00 u + m01 v) + m02) + t0) / ((d * (...) + t2) + 1e-7), so
    that the CUDA kernel reproduces x and y to the bit.
    """
    return _plane_sweep_reference(cur, lookup, M, t, depth_bins, chunk)


def plane_sweep_diffs_occ_reference(cur: Tensor, lookup: Tensor, occ: Tensor,
                                    apply_occ: Tensor, M: Tensor, t: Tensor,
                                    depth_bins: Tensor, pool_th: float,
                                    chunk: int = 16) -> Tensor:
    """K6's plain version: `plane_sweep_diffs_reference` with the DOMD
    occlusion mask occ (BF, h, w) warped by the same bilinear weights,
    ((o00 w00 + o01 w01) + o10 w10) + o11 w11 as the kernel sums it. Where
    the warped mask exceeds `pool_th` and the frame's apply_occ (BF,) is
    positive, the warped features become 1.0 before the channel mean
    (`mal_tpu/ops/pallas/cost_volume_kernel.py:284-290`)."""
    return _plane_sweep_reference(cur, lookup, M, t, depth_bins, chunk,
                                  occ=occ, apply_occ=apply_occ,
                                  pool_th=pool_th)


def _check(cur: Tensor, lookup: Tensor, M: Tensor, t: Tensor,
           depth_bins: Tensor, **extra: Tensor) -> None:
    """Raise on anything the kernels do not take; `extra`: K6's occ and
    apply_occ."""
    tensors = {"cur": cur, "lookup": lookup, "M": M, "t": t,
               "depth_bins": depth_bins, **extra}
    for name, x in tensors.items():
        if x.device != cur.device:
            raise ValueError(f"{name} is on {x.device}, cur on {cur.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cur.dim() != 4 or lookup.shape != cur.shape:
        raise ValueError(f"cur {tuple(cur.shape)} and lookup "
                         f"{tuple(lookup.shape)} must both be (BF, h, w, C)")
    BF, h, w, C = cur.shape
    if C % 4 or C > _MAX_CHANNELS:
        raise ValueError(f"channels must be a multiple of 4 and at most "
                         f"{_MAX_CHANNELS}, got {C}")
    if M.shape != (BF, 3, 3) or t.shape != (BF, 3) or depth_bins.dim() != 1:
        raise ValueError(f"M {tuple(M.shape)}, t {tuple(t.shape)}, bins "
                         f"{tuple(depth_bins.shape)} do not fit BF={BF}")
    if cur.data_ptr() % 16 or lookup.data_ptr() % 16:
        raise ValueError("cur and lookup must be 16-byte aligned")
    if "occ" in extra and (extra["occ"].shape != (BF, h, w)
                           or extra["apply_occ"].shape != (BF,)):
        raise ValueError(f"occ {tuple(extra['occ'].shape)} and apply_occ "
                         f"{tuple(extra['apply_occ'].shape)} do not fit "
                         f"(BF, h, w) = {(BF, h, w)}")


def plane_sweep_routes(M: Tensor, t: Tensor, depth_bins: Tensor, h: int,
                       w: int, C: int, occ: bool = False) -> dict[str, int]:
    """How many of K1's tiles (with `occ`, K6's) the kernel takes by each
    route, {"empty": n, "staged": n, "direct": n}, for M (BF, 3, 3), t
    (BF, 3), depth_bins (D,) and (h, w, C) features.

    Mirrors `csrc/plane_sweep.cu`: a tile is TILE_PLANES planes x
    TILE_PIXELS pixels of one row; its box is the corners' rows and columns
    over its samples inside the border masks; it is empty without such a
    sample, staged where the box's channel planes (each padded to 1 mod 8
    float4 words), and for K6 the box of the occlusion mask, fit in
    BOX_BYTES, and direct elsewhere. The projection is the plain version's,
    which the kernel reproduces to the bit, so the counts are the kernel's.
    """
    D = depth_bins.shape[0]
    P, U = TILE_PLANES, TILE_PIXELS
    Dp, Wp = -(-D // P) * P, -(-w // U) * U
    dev = M.device
    u = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, w)
    v = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, h, 1)
    d = depth_bins.to(torch.float32).reshape(D, 1, 1)
    inner = (u >= 2) & (u <= w - 3) & (v >= 2) & (v <= h - 3)
    inf = float("inf")
    counts = dict.fromkeys(ROUTES, 0)
    for m, tt in zip(M.reshape(-1, 9), t.reshape(-1, 3)):  # a frame at a time
        # the plain version's operations, in place where they may be
        zh = d * (m[6] * u + m[7] * v + m[8])
        zh += tt[2]
        zh += 1e-7
        x = d * (m[0] * u + m[1] * v + m[2])
        x += tt[0]
        x /= zh
        y = d * (m[3] * u + m[4] * v + m[5])
        y += tt[1]
        y /= zh
        outside = (x < 2.0) | ~inner
        outside |= x > w - 2
        outside |= y < 2.0
        outside |= y > h - 2
        outside |= torch.isnan(x) | torch.isnan(y)

        def reduce(a: Tensor, fill: float, fn) -> Tensor:
            """fn over each tile of (D, h, w) corners, fill where a sample
            is outside the masks or past the edge: (D / P, h, w / U)."""
            a = torch.nn.functional.pad(a.masked_fill_(outside, fill),
                                        (0, Wp - w, 0, 0, 0, Dp - D),
                                        value=fill)
            return fn(a.reshape(Dp // P, P, h, Wp // U, U), dim=(1, 4))

        x0, y0 = x.floor_(), y.floor_()
        lo_x, lo_y = reduce(x0, inf, torch.amin), reduce(y0, inf, torch.amin)
        hi_x, hi_y = reduce(x0, -inf, torch.amax), reduce(y0, -inf, torch.amax)
        full = torch.isfinite(lo_x)
        lo_x, hi_x, lo_y, hi_y = (torch.where(full, a, 0.0).long()
                                  for a in (lo_x, hi_x, lo_y, hi_y))
        pixels = (hi_x - lo_x + 2) * (hi_y - lo_y + 2)
        stride = pixels + (9 - pixels % 8) % 8
        need = stride * (C // 4) * 16 + (pixels * 4 if occ else 0)
        staged = full & (need <= BOX_BYTES)
        counts["empty"] += int((~full).sum())
        counts["staged"] += int(staged.sum())
        counts["direct"] += int((full & ~staged).sum())
    return counts


def _library() -> ctypes.CDLL:
    from mal_tpu_torch.ops.cuda.build import load_library

    lib = load_library(SOURCE)
    fn = lib.plane_sweep_diffs_f32
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        occ = lib.plane_sweep_diffs_occ_f32
        occ.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_float]
                        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                        + [ctypes.c_void_p])
        occ.restype = ctypes.c_int
        lib.plane_sweep_error_string.argtypes = [ctypes.c_int]
        lib.plane_sweep_error_string.restype = ctypes.c_char_p
    return lib


def _routes_ptr(routes: Tensor | None, cur: Tensor) -> int | None:
    """The device pointer of `routes`, an int32 (3,) tensor beside cur to
    which the kernel adds its tiles by route (ROUTES), or None."""
    if routes is None:
        return None
    if (routes.device != cur.device or routes.dtype != torch.int32
            or routes.shape != (len(ROUTES),) or not routes.is_contiguous()):
        raise ValueError(f"routes must be a contiguous int32 "
                         f"({len(ROUTES)},) tensor on {cur.device}")
    return routes.data_ptr()


def _cpu_chunk(depth_bins: Tensor) -> int:
    """The plain version's planes at a time on the CPU: the largest divisor
    of D up to 16 (a depth rank's share may be any D)."""
    D = depth_bins.shape[0]
    return max(c for c in range(1, min(D, 16) + 1) if D % c == 0)


def plane_sweep_diffs(cur: Tensor, lookup: Tensor, M: Tensor, t: Tensor,
                      depth_bins: Tensor, routes: Tensor | None = None) -> Tensor:
    """Per-frame masked L1 plane-sweep differences (BF, D, h, w).

    Arguments as `plane_sweep_diffs_reference`. CUDA tensors go to the
    kernel; CPU tensors to the plain version. `routes`: for CUDA tensors, an
    optional int32 (3,) tensor to which the kernel adds how many tiles it
    took by each route (ROUTES; `plane_sweep_routes` predicts them).
    """
    refuse_grad("plane_sweep_diffs", cur, lookup, M, t, depth_bins)
    if cur.device.type == "cpu":
        return plane_sweep_diffs_reference(cur, lookup, M, t, depth_bins,
                                           chunk=_cpu_chunk(depth_bins))
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    _check(cur, lookup, M, t, depth_bins)
    routes_ptr = _routes_ptr(routes, cur)
    BF, h, w, C = cur.shape
    D = depth_bins.shape[0]
    out = torch.empty((BF, D, h, w), dtype=torch.float32, device=cur.device)
    lib = _library()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plane_sweep_diffs_f32(
            cur.data_ptr(), lookup.data_ptr(), M.data_ptr(), t.data_ptr(),
            depth_bins.data_ptr(), out.data_ptr(), routes_ptr, BF, D, h, w, C,
            stream)
    if err:
        msg = lib.plane_sweep_error_string(err).decode()
        raise RuntimeError(f"plane_sweep_diffs launch failed: {msg} ({err})")
    plane_sweep_diffs.launches += 1
    return out


plane_sweep_diffs.launches = 0


def plane_sweep_diffs_occ(cur: Tensor, lookup: Tensor, occ: Tensor,
                          apply_occ: Tensor, M: Tensor, t: Tensor,
                          depth_bins: Tensor, pool_th: float,
                          routes: Tensor | None = None) -> Tensor:
    """K6: per-frame masked L1 plane-sweep differences (BF, D, h, w) with
    the `cv_set_1` occlusion substitution. Arguments as
    `plane_sweep_diffs_occ_reference`, and `routes` as in
    `plane_sweep_diffs`. CUDA tensors go to the kernel; CPU tensors to the
    plain version."""
    refuse_grad("plane_sweep_diffs_occ", cur, lookup, occ, apply_occ, M, t,
                depth_bins)
    if cur.device.type == "cpu":
        return plane_sweep_diffs_occ_reference(cur, lookup, occ, apply_occ, M,
                                               t, depth_bins, pool_th,
                                               chunk=_cpu_chunk(depth_bins))
    if cur.device.type != "cuda":
        raise ValueError(f"unsupported device {cur.device}")
    _check(cur, lookup, M, t, depth_bins, occ=occ, apply_occ=apply_occ)
    routes_ptr = _routes_ptr(routes, cur)
    BF, h, w, C = cur.shape
    D = depth_bins.shape[0]
    out = torch.empty((BF, D, h, w), dtype=torch.float32, device=cur.device)
    lib = _library()
    with torch.cuda.device(cur.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.plane_sweep_diffs_occ_f32(
            cur.data_ptr(), lookup.data_ptr(), occ.data_ptr(),
            apply_occ.data_ptr(), float(pool_th), M.data_ptr(), t.data_ptr(),
            depth_bins.data_ptr(), out.data_ptr(), routes_ptr, BF, D, h, w,
            C, stream)
    if err:
        msg = lib.plane_sweep_error_string(err).decode()
        raise RuntimeError(f"plane_sweep_diffs_occ launch failed: {msg} ({err})")
    plane_sweep_diffs_occ.launches += 1
    return out


plane_sweep_diffs_occ.launches = 0


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


def plane_sweep_cost_share(cur_feats: Tensor, lookup_feats: Tensor,
                           rel_poses: Tensor, K: Tensor, inv_K: Tensor,
                           depth_bins: Tensor, index: int, n: int) -> Tensor:
    """Depth rank `index` of `n`: K1 on its share of the planes
    (`ops/cost_volume.py:plane_share`) alone, its cost before the missing
    fill written into a zeroed (B, D, h, w) volume. The sum of the n shares
    is the unsplit volume's cost before the fill, exactly."""
    B, h, w, _ = cur_feats.shape
    D = depth_bins.shape[0]
    planes = cost_volume.plane_share(D, index, n)
    volume = cur_feats.new_zeros((B, D, h, w), dtype=torch.float32)
    volume[:, planes] = _frame_mean_cost(cur_feats, lookup_feats, rel_poses,
                                         K, inv_K, depth_bins[planes])
    return volume


def plane_sweep_cost_volume_kernel(cur_feats: Tensor, lookup_feats: Tensor,
                                   rel_poses: Tensor, K: Tensor, inv_K: Tensor,
                                   depth_bins: Tensor,
                                   depth: tuple | None = None):
    """Counterpart of `plane_sweep_cost_volume_pallas`: (cost_volume,
    missing_mask), each (B, D, h, w); a missing entry of the cost takes its
    pixel's largest cost.

    cur_feats (B, h, w, C); lookup_feats (B, F, h, w, C); rel_poses
    (B, F, 4, 4) where an all-zero pose marks a missing frame; K / inv_K
    (B, 4, 4) at feature scale; depth_bins (D,). The per-frame differences
    come from `plane_sweep_diffs`; what surrounds them stays plain torch, as
    it stays XLA in `mal_tpu`: the projection terms, valid-frame masking,
    the sum / count over frames and the missing -> max fill.

    `depth` (group, index, n), a depth row (`parallel/mesh.py:depth_share`):
    this rank launches K1 on share `index` of the planes only, the row
    gathers the volume, and the fill spans all D planes after the gather.
    """
    if depth is None:
        cost = _frame_mean_cost(cur_feats, lookup_feats, rel_poses, K, inv_K,
                                depth_bins)
    else:
        group, index, n = depth
        cost = cost_volume.gather_planes(
            plane_sweep_cost_share(cur_feats, lookup_feats, rel_poses, K,
                                   inv_K, depth_bins, index, n), group)
    return cost_volume.fill_missing(cost)
