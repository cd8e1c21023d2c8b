"""K6, the occlusion-aware plane-sweep differences of DynamicDepth's cost
volume (`mal_tpu_torch/csrc/plane_sweep.cu`, K1's kernel as
`template <bool kOcc>`): its operations and bytes for the inputs of one
launch, copied frozen from `chip_smoke.py:k6_phase`, and the samples those
inputs make it compute, from K6's own projection, border masks and
occlusion test (the plain version's arithmetic, which the kernel
reproduces to the bit).

No module boundary of the port carries K6's inputs, so `capture` keeps
what the model's forward was given and gave (a forward hook), and
`launch_inputs` works the launch's geometry out again as the port's
`dynamic/model.py` does: the matching augmentation's zeroing redone from
the step's own draw, the intrinsics at the matching scale, the bins, and
the lookup frames after the DOMD warp (`reference/dynamicdepth/domd.py`)
for the occlusion mask."""

from __future__ import annotations

import torch

KERNEL_NAMES = ("plane_sweep_diffs_kernel<true",)
CHANNELS = 64      # the matching features: a ResNet's stage-1 width


def capture(model: torch.nn.Module, sink: list):
    """Keep, in each forward of a DynamicDepth model, what K6's inputs are
    made from; None for another model."""
    if type(model).__name__ != "DynDepthModel":
        return None

    def keep(module, args, kwargs, outputs):
        inputs, lo, hi = args[:3]
        sink.append({
            "cfg": module.cfg, "inputs": inputs,
            "aug_draw": kwargs.get("aug_draw"),
            "min": lo.detach().clone(), "max": hi.detach().clone(),
            "rel_pose": outputs["relative_pose/-1"].detach(),
            "T_0m1": outputs["cam_T_cam/0/-1"].detach(),
            "mono_disp": outputs["mono_disp"].detach()})

    return model.register_forward_hook(keep, with_kwargs=True)


def launch_inputs(kept: dict) -> dict:
    """The geometry of the launch a captured forward made: poses (B, 1, 4,
    4), K / inv_K (B, 4, 4) at the matching scale, the bins (D,), the
    occlusion mask (B, h, w), which items apply it (B,) and pool_th."""
    from gpubench.reference.dynamicdepth.cost_volume import occlusion_mask
    from gpubench.reference.dynamicdepth.domd import domd_warp_inputs
    from gpubench.reference.dynamicdepth.model import matching_augmentation
    from gpubench.reference.models.mal_model import to_nchw
    from gpubench.reference.ops.cost_volume import compute_depth_bins

    cfg, batch = kept["cfg"], to_nchw(kept["inputs"])
    rel = kept["rel_pose"]
    B, _, H, W = batch["color"]["0"].shape
    static, zero_cv, aug_mask = matching_augmentation(cfg, kept["aug_draw"])
    poses = torch.where(zero_cv[:, None, None], 0.0, rel)[:, None]
    lookup = torch.where(static[:, None, None, None],
                         batch["color"]["0"], batch["color_aug"]["-1"])[:, None]
    if "doj_mask" in batch and not cfg.no_warp:
        _, _, lookup = domd_warp_inputs(
            cfg, batch, kept["mono_disp"].permute(0, 3, 1, 2), kept["T_0m1"],
            kept["T_0m1"], aug_mask, lookup, is_train=False)
    factor = torch.tensor([0.25, 0.25, 1.0, 1.0], dtype=batch["K"].dtype,
                          device=rel.device)
    K = batch["K"] * factor[None, :, None]
    h, w = H // 4, W // 4
    return {"poses": poses, "K": K, "inv_K": torch.linalg.inv_ex(K).inverse,
            "bins": compute_depth_bins(kept["min"], kept["max"],
                                       cfg.num_depth_bins, cfg.depth_binning),
            "occ": occlusion_mask(lookup, h, w)[:, 0],
            "apply": aug_mask == 0, "pool_th": cfg.cv_pool_th, "h": h, "w": w}


def samples(poses: torch.Tensor, K: torch.Tensor, inv_K: torch.Tensor,
            bins: torch.Tensor, occ: torch.Tensor, apply: torch.Tensor,
            pool_th: float, h: int, w: int) -> dict[str, int]:
    """Samples (frame, plane, pixel) by what K6 does with them: `inside`
    K1's border masks; of those, `tested` in a frame that applies the
    occlusion substitution, and `occluded`, whose warped mask exceeds
    pool_th there. poses (B, F, 4, 4); K / inv_K (B, 4, 4) at the feature
    scale; bins (D,); occ (B * F, h, w); apply (B * F,) bool."""
    B, F = poses.shape[:2]
    P = (K[:, None] @ poses)[:, :, :3, :]
    M = (P[:, :, :, :3] @ inv_K[:, None, :3, :3]).reshape(B * F, 9, 1, 1, 1)
    t = P[:, :, :, 3].reshape(B * F, 3, 1, 1, 1)
    dev = poses.device
    u = torch.arange(w, dtype=torch.float32, device=dev).reshape(1, 1, 1, w)
    v = torch.arange(h, dtype=torch.float32, device=dev).reshape(1, 1, h, 1)
    ax = M[:, 0] * u + M[:, 1] * v + M[:, 2]
    ay = M[:, 3] * u + M[:, 4] * v + M[:, 5]
    az = M[:, 6] * u + M[:, 7] * v + M[:, 8]
    inner = (u >= 2) & (u <= w - 3) & (v >= 2) & (v <= h - 3)
    flat = occ.reshape(-1)
    base = (torch.arange(B * F, device=dev) * (h * w)).reshape(-1, 1, 1, 1)
    applied = apply.reshape(-1, 1, 1, 1)
    out = {"inside": 0, "tested": 0, "occluded": 0}
    for d in bins.to(torch.float32).reshape(-1, 1, 1, 1):
        zh = d * az + t[:, 2]
        x = (d * ax + t[:, 0]) / (zh + 1e-7)
        y = (d * ay + t[:, 1]) / (zh + 1e-7)
        edge = (x >= 2.0) & (x <= w - 2) & (y >= 2.0) & (y <= h - 2)
        inside = edge & inner
        # the warped mask, its corners summed in the kernel's order
        x0, y0 = torch.floor(x), torch.floor(y)
        wx1, wy1 = x - x0, y - y0
        wx0, wy0 = 1.0 - wx1, 1.0 - wy1
        warped = 0.0
        for xi, yi, wgt in ((x0, y0, wx0 * wy0), (x0 + 1, y0, wx1 * wy0),
                            (x0, y0 + 1, wx0 * wy1),
                            (x0 + 1, y0 + 1, wx1 * wy1)):
            ok = (xi >= 0) & (xi <= w - 1) & (yi >= 0) & (yi <= h - 1)
            idx = (yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
                   + base)
            warped = warped + flat[idx] * (wgt * ok)
        tested = inside & applied
        out["inside"] += int(inside.sum())
        out["tested"] += int(tested.sum())
        out["occluded"] += int((tested & (warped > pool_th)).sum())
    return out


def counts(frames: int, h: int, w: int, planes: int, found: dict,
           applied_frames: int, channels: int = CHANNELS
           ) -> tuple[float, float]:
    """(bytes, operations) of one launch (`chip_smoke.py:k6_phase`): each
    input read once and the output written once; ~10 operations a sample
    for the projection and the masks; inside them ~15 for the bilinear
    weights and, where the frame applies the substitution, ~8 for the
    warped mask and its test; the feature gathers (9 a channel) for the
    samples not occluded; and 2 a channel for each pixel's occluded value
    in a frame that applies it."""
    feats = frames * h * w * channels
    out = frames * planes * h * w
    n_bytes = 4 * (2 * feats + frames * h * w + frames + 9 * frames
                   + 3 * frames + planes + out)
    n_ops = (10 * out + 15 * found["inside"] + 8 * found["tested"]
             + 9 * channels * (found["inside"] - found["occluded"])
             + 2 * channels * applied_frames * h * w)
    return float(n_bytes), float(n_ops)
