"""Mask2Former training criterion: Hungarian set matching and point-sampled
mask losses (PyTorch).

Counterpart of `mal_tpu.segment.criterion` (reference `mask2former/
modeling/matcher.py:70-179`, HungarianMatcher, and `criterion.py:90-247`,
SetCriterion). Targets are padded to a static T with a validity mask, as
in `mal_tpu`; the losses run at fixed point counts.

Matching: `mal_tpu` solves each assignment on the device inside its jitted
step. Here the cost matrices of every decoder layer and image are built on
the tensors' device first, square-embedded as `mal_tpu`'s `match_one` does
(invalid and dummy columns cost 0), copied to the host in one transfer (one
synchronisation a step, not one per image per layer as the reference's
scipy call makes) and solved together by `segment/matcher.py:
hungarian_match`, the exact float32 solver that breaks ties as `mal_tpu`'s.

Random points: `mal_tpu` draws them with `jax.random`, which torch cannot
reproduce. Here they come from an explicit `torch.Generator`, or the caller
injects every draw (`draws`): per decoder layer the matching coordinates
(B, num_points, 2), the oversampled coordinates (B*T, 3 num_points, 2) and
the random coordinates (B*T, num_points / 4, 2) of PointRend's importance
sampling.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from mal_tpu_torch.segment.matcher import hungarian_match

Tensor = torch.Tensor


class CriterionConfig(NamedTuple):
    """Hyper-parameters, defaults = the reference's `mask2former/config.py`
    (`:34-37` weights, `:108-114` point sampling)."""

    num_classes: int = 80
    eos_coef: float = 0.1
    cost_class: float = 1.0
    cost_mask: float = 20.0
    cost_dice: float = 1.0
    num_points: int = 112 * 112
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75


def point_counts(cfg: CriterionConfig) -> tuple[int, int, int]:
    """(oversampled, importance-sampled, random) point counts a mask."""
    n_unc = int(cfg.importance_sample_ratio * cfg.num_points)
    return (int(cfg.num_points * cfg.oversample_ratio), n_unc,
            cfg.num_points - n_unc)


def point_sample(masks: Tensor, coords: Tensor) -> Tensor:
    """Bilinear point sampling with grid_sample's semantics (align_corners
    False, zero padding), as `mal_tpu/segment/criterion.py:62-92` gathers
    it. masks (N, H, W); coords (N, P, 2) in [0, 1] as (x, y). Returns
    (N, P)."""
    H, W = masks.shape[-2:]
    px = coords[..., 0] * W - 0.5
    py = coords[..., 1] * H - 0.5
    x0 = px.floor()
    y0 = py.floor()
    wx = px - x0
    wy = py - y0
    flat = masks.reshape(*masks.shape[:-2], H * W)

    def corner(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        xc = xi.clamp(0, W - 1).long()
        yc = yi.clamp(0, H - 1).long()
        v = flat.gather(-1, yc * W + xc)
        return torch.where(inb, v, 0.0)

    v00 = corner(y0, x0)
    v01 = corner(y0, x0 + 1)
    v10 = corner(y0 + 1, x0)
    v11 = corner(y0 + 1, x0 + 1)
    return ((1 - wy) * ((1 - wx) * v00 + wx * v01)
            + wy * ((1 - wx) * v10 + wx * v11))


def _bce_with_logits(x: Tensor, z: Tensor) -> Tensor:
    # `mal_tpu`'s numerically stable form, term for term
    return x.clamp(min=0.0) - x * z + torch.log1p(torch.exp(-x.abs()))


def match_cost_matrix(logits: Tensor, mask_pts: Tensor, tgt_labels: Tensor,
                      tgt_pts: Tensor, cfg: CriterionConfig) -> Tensor:
    """Matching costs (B, Q, T) (`matcher.py:105-148`). logits (B, Q, K+1);
    mask_pts (B, Q, P) mask logits at the shared points; tgt_labels (B, T);
    tgt_pts (B, T, P) target values at the same points."""
    B, Q, _ = logits.shape
    P = mask_pts.shape[-1]
    prob = logits.softmax(dim=-1)
    cost_class = -prob.gather(2, tgt_labels[:, None, :].expand(B, Q, -1))

    pos = _bce_with_logits(mask_pts, torch.ones_like(mask_pts))
    neg = _bce_with_logits(mask_pts, torch.zeros_like(mask_pts))
    cost_mask = (pos @ tgt_pts.transpose(1, 2)
                 + neg @ (1.0 - tgt_pts).transpose(1, 2)) / P

    sig = mask_pts.sigmoid()
    numer = 2.0 * (sig @ tgt_pts.transpose(1, 2))
    denom = sig.sum(-1)[:, :, None] + tgt_pts.sum(-1)[:, None, :]
    cost_dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    return (cfg.cost_mask * cost_mask + cfg.cost_class * cost_class
            + cfg.cost_dice * cost_dice)


def _uncertain_point_coords(mask_logits: Tensor, cfg: CriterionConfig,
                            oversample: Tensor, rand: Tensor) -> Tensor:
    """PointRend's importance sampling with uncertainty -|logit|
    (`criterion.py:73-87,161-169`): the `num_points * importance_sample_
    ratio` most uncertain of the oversampled points, then the random ones.
    mask_logits (N, H, W), detached. Returns (N, num_points, 2)."""
    _, n_unc, n_rand = point_counts(cfg)
    uncertainty = -point_sample(mask_logits, oversample).abs()
    idx = uncertainty.topk(n_unc, dim=1).indices
    coords = oversample.gather(1, idx[..., None].expand(-1, -1, 2))
    if n_rand > 0:
        coords = torch.cat([coords, rand], dim=1)
    return coords


def match_predictions(pred_logits: Tensor, pred_masks: Tensor,
                      tgt_labels: Tensor, tgt_masks: Tensor,
                      tgt_valid: Tensor, match_coords: list[Tensor],
                      cfg: CriterionConfig,
                      timings: dict | None = None) -> Tensor:
    """The matched query of each target, (L, B, T) on the device, for
    stacked predictions of L layers (`criterion.set_criterion_deep`'s
    shapes), each layer's costs taken at its `match_coords` (B, P, 2):
    every cost matrix first, then one copy to the host and one solve.
    `timings` gets the copy's and the solve's host ms ("match_copy_ms",
    "match_solve_ms"), the device synchronized first so that the copy does
    not also wait for the forward."""
    L, B, Q = pred_logits.shape[:3]
    T = tgt_labels.shape[1]
    costs = []
    with torch.no_grad():
        for l in range(L):
            c = match_coords[l]
            pred_pts = point_sample(
                pred_masks[l].reshape(B * Q, *pred_masks.shape[3:]),
                c.repeat_interleave(Q, dim=0)).reshape(B, Q, -1)
            tgt_pts = point_sample(
                tgt_masks.reshape(B * T, *tgt_masks.shape[2:]),
                c.repeat_interleave(T, dim=0)).reshape(B, T, -1)
            costs.append(match_cost_matrix(pred_logits[l], pred_pts,
                                           tgt_labels, tgt_pts, cfg))
        cost = torch.stack(costs)                          # (L, B, Q, T)
        square = torch.zeros((L, B, Q, Q), dtype=torch.float32,
                             device=cost.device)
        square[..., :T] = torch.where(tgt_valid[None, :, None, :], cost, 0.0)
        if timings is not None and square.is_cuda:
            torch.cuda.synchronize(square.device)
        t0 = time.perf_counter()
        host = square.cpu().numpy()                        # the one sync
        t1 = time.perf_counter()
        src = hungarian_match(host)[..., :T]
        if timings is not None:
            timings["match_copy_ms"] = 1e3 * (t1 - t0)
            timings["match_solve_ms"] = 1e3 * (time.perf_counter() - t1)
    return torch.from_numpy(src).to(pred_logits.device)


def _layer_losses(pred_logits: Tensor, pred_masks: Tensor, src: Tensor,
                  tgt_labels: Tensor, tgt_masks: Tensor, tgt_valid: Tensor,
                  oversample: Tensor, rand: Tensor, num_masks: Tensor,
                  cfg: CriterionConfig) -> dict[str, Tensor]:
    """One layer's losses on its matching (`criterion.py:122-190`)."""
    B, Q, _ = pred_logits.shape
    T = tgt_labels.shape[1]
    # weighted-mean CE over all queries: matched queries take the target
    # label, the others the no-object class; padded targets scatter the
    # no-object class into their (distinct) matched rows, a no-op
    scatter_lab = torch.where(tgt_valid, tgt_labels.long(), cfg.num_classes)
    target_classes = torch.full((B, Q), cfg.num_classes, dtype=torch.long,
                                device=pred_logits.device)
    target_classes = target_classes.scatter(1, src, scatter_lab)
    logp = pred_logits.log_softmax(dim=-1)
    nll = -logp.gather(2, target_classes[..., None])[..., 0]
    w = torch.where(target_classes == cfg.num_classes, cfg.eos_coef, 1.0)
    loss_ce = (w * nll).sum() / w.sum()

    h, wd = pred_masks.shape[-2:]
    mp = pred_masks.gather(1, src[:, :, None, None].expand(B, T, h, wd))
    mp = mp.reshape(B * T, h, wd)
    tm = tgt_masks.reshape(B * T, *tgt_masks.shape[2:])
    pc = _uncertain_point_coords(mp.detach(), cfg, oversample, rand)
    point_logits = point_sample(mp, pc)
    with torch.no_grad():
        point_labels = point_sample(tm, pc)
    vflat = tgt_valid.reshape(B * T).to(point_logits.dtype)

    ce = _bce_with_logits(point_logits, point_labels).mean(-1)
    loss_mask = (ce * vflat).sum() / num_masks
    sig = point_logits.sigmoid()
    numer = 2.0 * (sig * point_labels).sum(-1)
    denom = sig.sum(-1) + point_labels.sum(-1)
    dice = 1.0 - (numer + 1.0) / (denom + 1.0)
    loss_dice = (dice * vflat).sum() / num_masks
    return {"loss_ce": loss_ce, "loss_mask": loss_mask,
            "loss_dice": loss_dice}


def draw_points(cfg: CriterionConfig, layers: int, batch: int, targets: int,
                generator: torch.Generator | None = None,
                device: str | torch.device = "cpu") -> list[dict]:
    """Every random point of a criterion call, per layer: {"match" (B, P,
    2), "oversample" (B*T, 3P, 2), "rand" (B*T, P/4, 2)}, uniform in [0, 1)
    from `generator` on `device`."""
    n_over, _, n_rand = point_counts(cfg)
    N = batch * targets
    shapes = {"match": (batch, cfg.num_points, 2),
              "oversample": (N, n_over, 2), "rand": (N, n_rand, 2)}
    return [{k: torch.rand(s, generator=generator, device=device)
             for k, s in shapes.items()} for _ in range(layers)]


def set_criterion_deep(pred_logits: Tensor, pred_masks: Tensor,
                       tgt_labels: Tensor, tgt_masks: Tensor,
                       tgt_valid: Tensor,
                       cfg: CriterionConfig = CriterionConfig(),
                       generator: torch.Generator | None = None,
                       draws: list[dict] | None = None,
                       num_masks: Tensor | None = None,
                       timings: dict | None = None) -> dict[str, Tensor]:
    """Deep supervision (`criterion.py:239-245`): pred_logits (L, B, Q, K+1)
    and pred_masks (L, B, Q, H, W) logits, layer L-1 the final prediction;
    tgt_labels (B, T) int, tgt_masks (B, T, Ht, Wt) binary float, tgt_valid
    (B, T) bool. Returns the final layer's {"loss_ce", "loss_mask",
    "loss_dice"} (unweighted) and the other layers' with the suffix `_{i}`.

    `draws` (see `draw_points`) replaces the draws from `generator`;
    `num_masks`, the matched-pair normaliser, defaults to this batch's valid
    count; `timings` as `match_predictions`."""
    L, B = pred_logits.shape[:2]
    T = tgt_labels.shape[1]
    if draws is None:
        draws = draw_points(cfg, L, B, T, generator, pred_logits.device)
    src = match_predictions(pred_logits, pred_masks, tgt_labels, tgt_masks,
                            tgt_valid, [d["match"] for d in draws], cfg,
                            timings)
    if num_masks is None:
        num_masks = tgt_valid.sum()
    num_masks = num_masks.to(torch.float32).clamp(min=1.0)
    out = {}
    for l in [L - 1] + list(range(L - 1)):
        losses = _layer_losses(pred_logits[l], pred_masks[l], src[l],
                               tgt_labels, tgt_masks, tgt_valid,
                               draws[l]["oversample"], draws[l]["rand"],
                               num_masks, cfg)
        suffix = "" if l == L - 1 else f"_{l}"
        out.update({k + suffix: v for k, v in losses.items()})
    return out


def set_criterion(pred_logits: Tensor, pred_masks: Tensor, tgt_labels: Tensor,
                  tgt_masks: Tensor, tgt_valid: Tensor,
                  cfg: CriterionConfig = CriterionConfig(),
                  generator: torch.Generator | None = None,
                  draws: dict | None = None,
                  num_masks: Tensor | None = None) -> dict[str, Tensor]:
    """The criterion of one set of predictions, pred_logits (B, Q, K+1) and
    pred_masks (B, Q, H, W) (`criterion.py:212-247` without the aux loop);
    `draws` is one layer's dict of `draw_points`."""
    return set_criterion_deep(pred_logits[None], pred_masks[None], tgt_labels,
                              tgt_masks, tgt_valid, cfg, generator,
                              None if draws is None else [draws], num_masks)


def weight_dict(cfg: CriterionConfig, num_aux_layers: int) -> dict[str, float]:
    """`maskformer_model.py:118-125`: the loss weights, with a copy for each
    auxiliary layer."""
    base = {"loss_ce": cfg.cost_class, "loss_mask": cfg.cost_mask,
            "loss_dice": cfg.cost_dice}
    out = dict(base)
    for i in range(num_aux_layers):
        out.update({f"{k}_{i}": v for k, v in base.items()})
    return out


def weighted_total(losses: dict[str, Tensor],
                   weights: dict[str, float]) -> Tensor:
    """The training objective, the weighted sum (`maskformer_model.py:
    210-216`)."""
    return sum(losses[k] * w for k, w in weights.items() if k in losses)
