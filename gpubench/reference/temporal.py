"""MAL temporal hint: dynamic-object motion-midpoint synthesis (PyTorch).

Counterpart of `mal_tpu.temporal`, itself a re-design of
`manydepth/dyn_utils.py` (`image_synthesis`, `generate_dynamic_instance`,
`fill_dynamic_obj`): dynamic objects of the current frame are matched to
instances of the warped adjacent frames, and each object's pixels move to
its motion-interpolated midpoint (half the bbox-extent delta), with the
background filled in from the other adjacent frame.

Images are channels-first here, (B, C, H, W); instance masks (B, N, H, W).
Shifts are gathers, so the synthesized frames stay differentiable with
respect to the warped frames. An item without a matched pair keeps its
warped frames, which makes its extra min-reprojection candidates a no-op.
"""

from __future__ import annotations

import torch

from gpubench.reference.segment.instances import Instances
from gpubench.reference.segment.matcher import match_instances

Tensor = torch.Tensor


def _bbox_bounds(mask: Tensor):
    """Per-instance bbox bounds with the reference's index arithmetic
    (`dyn_utils.py:53-78`): occupancy is detected through index-weighted
    sums, so row / column 0 counts as empty (quirk kept), and argmax /
    argmin take the first index.

    mask: (B, N, H, W) bool. Returns (low, top, right, left), each (B, N).
    """
    H, W = mask.shape[-2:]
    rows = torch.arange(H, device=mask.device)
    cols = torch.arange(W, device=mask.device)
    inf = (H + 1) * (W + 1)

    h_nz = torch.where((mask * rows[:, None]).sum(-1) == 0, 0, rows)
    low = h_nz.argmax(-1)
    top = torch.where(h_nz == 0, inf, h_nz).argmin(-1)
    w_nz = torch.where((mask * cols).sum(-2) == 0, 0, cols)
    right = w_nz.argmax(-1)
    left = torch.where(w_nz == 0, inf, w_nz).argmin(-1)
    return low, top, right, left


def _shift2d(x: Tensor, dy: Tensor, dx: Tensor) -> Tensor:
    """x (B, C, H, W) shifted by (dy[b] rows, dx[b] cols), zero-filled:
    out[r, c] = x[r - dy, c - dx] where that lies inside the image."""
    B, C, H, W = x.shape
    r = torch.arange(H, device=x.device) - dy[:, None]      # (B, H)
    c = torch.arange(W, device=x.device) - dx[:, None]      # (B, W)
    ok = (((r >= 0) & (r < H))[:, None, :, None]
          & ((c >= 0) & (c < W))[:, None, None, :])
    y = x.gather(2, r.clamp(0, H - 1)[:, None, :, None].expand(B, C, H, W))
    y = y.gather(3, c.clamp(0, W - 1)[:, None, None, :].expand(B, C, H, W))
    return torch.where(ok, y, torch.zeros((), dtype=x.dtype, device=x.device))


def _fill_dynamic_obj(mask: Tensor, delta_x: Tensor, delta_y: Tensor,
                      source: Tensor, img_bg: Tensor) -> Tensor:
    """Move each instance's pixels by its (delta_x rows, delta_y cols).

    mask: (B, N, H, W) bool; delta_*: (B, N); source, img_bg: (B, C, H, W).
    Reference: `dyn_utils.py:5-36` (sum over the shifted instances, OR of
    the shifted masks, the background elsewhere).
    """
    img_sum = torch.zeros_like(source)
    mask_or = torch.zeros_like(mask[:, 0])
    for n in range(mask.shape[1]):
        src_mv = _shift2d(source, delta_x[:, n], delta_y[:, n])
        m_mv = _shift2d(mask[:, n, None].to(source.dtype), delta_x[:, n],
                        delta_y[:, n])[:, 0] > 0
        img_sum = img_sum + src_mv * m_mv[:, None]
        mask_or = mask_or | m_mv
    return torch.where(mask_or[:, None], img_sum, img_bg)


def generate_dynamic_instance(mask_last: Tensor, mask_next: Tensor,
                              img_last: Tensor, img_next: Tensor):
    """Midpoint-position objects in both warped frames, batched.

    mask_*: (B, N, H, W) bool matched instance masks; img_*: (B, C, H, W).
    Reference: `dyn_utils.py:38-119` (`replace=False`, the only form the
    synthesis uses).
    """
    mask_or_any = (mask_last | mask_next).any(1)[:, None]   # (B, 1, H, W)
    low_l, top_l, right_l, left_l = _bbox_bounds(mask_last)
    low_n, top_n, right_n, left_n = _bbox_bounds(mask_next)

    def pick(d1, d2):
        """The larger in magnitude, d1 on a tie (argmax's first index)."""
        return torch.where(d2.abs() > d1.abs(), d2, d1)

    delta_x = pick(low_n - low_l, top_n - top_l)
    delta_y = pick(right_n - right_l, left_n - left_l)
    # round half to even, as jnp.round: odd deltas land exactly on .5
    disp_x = torch.round(delta_x / 2.0).long()
    disp_y = torch.round(delta_y / 2.0).long()

    # background infill: pixels the object vacates come from the other frame
    vac_last = (mask_last & ~mask_next).any(1)[:, None]
    img_bg = torch.where(vac_last, img_next, img_last)
    vac_next = (mask_next & ~mask_last).any(1)[:, None]
    img_bg2 = torch.where(vac_next, img_last, img_next)

    syn_last = _fill_dynamic_obj(mask_last, disp_x, disp_y, img_last, img_bg)
    syn_next = _fill_dynamic_obj(mask_next, -disp_x, -disp_y, img_next,
                                 img_bg2)
    return (torch.where(mask_or_any, syn_last, img_last),
            torch.where(mask_or_any, syn_next, img_next))


def image_synthesis(warped_last: Tensor, warped_next: Tensor,
                    inst_cur: Instances, inst_last: Instances,
                    inst_next: Instances, score_thresh: float = 0.5,
                    payload_dtype: torch.dtype | None = None):
    """Batch temporal-hint synthesis (`dyn_utils.py:121-170`).

    warped_*: (B, C, H, W) warped adjacent frames of the photometric path;
    inst_cur: the current frame's instances; inst_last / inst_next: the
    instances of the *warped* adjacent frames. Returns (syn_last, syn_next,
    has_ins), has_ins (B,) bool.

    `payload_dtype=torch.bfloat16` (fast mode, `mal_tpu/temporal.py:151-176`)
    moves the frames through the per-instance shifts in bf16; the results
    come back in the frames' own type, and gradients flow through the casts.
    """
    out_dtype = warped_last.dtype
    if payload_dtype is not None:
        warped_last = warped_last.to(payload_dtype)
        warped_next = warped_next.to(payload_dtype)
    cur = inst_cur.threshold(score_thresh)
    last_idx, next_idx, pair_valid = match_instances(inst_last, inst_next, cur)
    pv = (pair_valid & cur.valid)[:, :, None, None]
    H, W = warped_last.shape[-2:]

    def matched(masks, idx):
        picked = masks.gather(1, idx[:, :, None, None].expand(-1, -1, H, W))
        return (picked > 0.5) & pv

    syn_l, syn_n = generate_dynamic_instance(
        matched(inst_last.masks, last_idx), matched(inst_next.masks, next_idx),
        warped_last, warped_next)
    has = pv.flatten(1).any(1)
    keep = has[:, None, None, None]
    return (torch.where(keep, syn_l, warped_last).to(out_dtype),
            torch.where(keep, syn_n, warped_next).to(out_dtype), has)
