"""The MAL training step (PyTorch).

Counterpart of `mal_tpu.train.step`: the teacher and student forward
passes, the photometric warps, the MAL temporal hint (frames synthesized
from the frozen segmenter's instances, `temporal` / `main_temporal`; the
current frame's from the batch with `seg_cache_root`), the MAL
distillation, the loss balancer or the pareto (MGDA) weighting, the Adam
update (with the BN statistics updated by the forward) and the adaptive
depth-bin EMA (`manydepth/trainer.py:449-644`). `remat` recomputes the
trunks and the loss assemblies in the backward.

Fast mode (`compute_dtype="bfloat16"`, `mal_tpu.config.TRAIN_FAST_SETTINGS`):
the depth and pose nets compute in bf16 on fp32 parameters
(`models/mal_model.py`), the warped frames carry a bf16 *payload* with fp32
coordinates and weights, and the synthesis moves its frames in bf16. The
losses, the optimizer, the depth bins and the balancer stay fp32.

Random draws: the matching augmentation's uniform draw and the automask
tie-break noise come from `generator`, or are passed in `draws` so that a
test can feed both packages the same numbers.

Data parallelism: in a process group of N processes (`parallel/
distributed.py`) each step runs on the process's shard inside
`parallel/mesh.py:data_axis`, with the gradients summed over the ranks
before the update: the step of the N shards is the one-process step on
their concatenation, as `mal_tpu`'s mesh step is. With `num_depth_shards`
> 1 the ranks of a depth row hold one shard, and the ManyDepth step splits
the cost volume's planes over the row (`parallel/mesh.py:depth_axis`).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from mal_tpu_torch import geometry, losses
from mal_tpu_torch.config import Config
from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.models.mal_model import MALModel, to_nchw
from mal_tpu_torch.models.resnet import remat
from mal_tpu_torch.ops.interp import grid_sample
from mal_tpu_torch.ops.precision import compute_dtype_of
from mal_tpu_torch.parallel import distributed, mesh
from mal_tpu_torch.pareto import pareto_weights_2task
from mal_tpu_torch.segment.cache import instances_from_batch
from mal_tpu_torch.temporal import image_synthesis
from mal_tpu_torch.train.lr_schedule import make_schedule
from mal_tpu_torch.train.state import TrainState, apply_gradients
from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor


# `mal_tpu` cannot run `loss_pct` either, and the port adds nothing that
# `mal_tpu` lacks
LOSS_PCT_REFUSAL = (
    "loss_pct: mal_tpu cannot run it: its step logs mono_out.mask_pct and "
    "multi_out.mask_pct (mal_tpu/train/step.py:318-322), which neither "
    "MonoLossOut nor MultiLossOut has (mal_tpu/losses.py:163-167,229-235), "
    "so it raises AttributeError there")


def check_supported(cfg: Config, seg_fn: Callable | None = None) -> None:
    """Raise for the options whose code paths are not ported yet, for those
    `mal_tpu` cannot run, for the temporal hint without a segmenter, and
    for a `num_data_shards` that does not fit the process group."""
    if cfg.method not in ("manydepth", "dynamicdepth", "dualrefine"):
        raise ValueError(f"unknown method {cfg.method!r}")
    dynamic = cfg.method == "dynamicdepth"
    check_parallel(cfg, distributed.world())
    if cfg.method == "dualrefine":
        # mal_tpu's DualRefine step reads none of the ManyDepth options; it
        # asserts the frame pair (`mal_tpu/dualref/step.py:74-75`)
        compute_dtype_of(cfg.compute_dtype)
        if tuple(cfg.frame_ids[:2]) != (0, -1):
            raise ValueError("DualRefine trains on the (0, -1) frame pair, "
                             f"got frame_ids={cfg.frame_ids}")
        return
    if cfg.loss_pct:
        raise NotImplementedError(LOSS_PCT_REFUSAL)
    compute_dtype_of(cfg.compute_dtype)   # raises on an unknown type
    if dynamic:
        if cfg.remat:
            raise NotImplementedError(
                "remat with method='dynamicdepth': mal_tpu's DynDepthModel "
                "has no rematerialised form (mal_tpu/dynamic/model.py), so "
                "the option would change nothing")
        return
    if (cfg.temporal or cfg.main_temporal) and seg_fn is None:
        raise ValueError("cfg.temporal requires a segmentation seg_fn")
    if cfg.learn_ens:
        # as mal_tpu: the reference's ens_disp producer is missing from its
        # snapshot (`manydepth/loss_utils.py:240` reads a key no module writes)
        raise NotImplementedError("learn_ens: broken in the reference")


LAUNCH = "--coordinator host:port --num_hosts N --host_id i"


def check_parallel(cfg: Config, world: int,
                   global_batch: int | None = None) -> None:
    """Raise for the parallel layouts a run of `world` processes cannot
    take: more than one depth shard or data shard in one process
    (`mal_tpu`'s single-process device mesh, which the port runs as one
    process per card), a `num_depth_shards` that does not divide the
    processes, a `num_data_shards` other than what is left of them, and a
    `global_batch` (where the caller shards one) that the data shards do
    not divide."""
    n_depth, shards = cfg.num_depth_shards, cfg.num_data_shards
    if n_depth < 1:
        raise ValueError(f"num_depth_shards={n_depth} must be at least 1")
    if world == 1 and n_depth > 1:
        raise NotImplementedError(
            f"num_depth_shards={n_depth} in one process: the port splits "
            f"the cost volume's planes across processes, one per card, "
            f"launched with {LAUNCH} where num_depth_shards divides N "
            f"(README, ROADMAP M6)")
    if world == 1 and shards > 1:
        raise NotImplementedError(
            f"num_data_shards={shards} in one process: the port's data "
            f"parallelism runs one process per card, launched with {LAUNCH}"
            f" (README, ROADMAP M6)")
    if world % n_depth:
        raise ValueError(
            f"num_depth_shards={n_depth} does not divide the {world} "
            f"processes of --num_hosts {world}: launch a multiple of "
            f"{n_depth} ({LAUNCH})")
    n_data = world // n_depth
    if n_depth == 1 and shards not in (0, 1, world):
        raise ValueError(f"num_data_shards={shards} must be 0, 1 or the "
                         f"number of processes, {world}")
    if n_depth > 1 and shards not in (0, n_data):
        raise ValueError(
            f"num_data_shards={shards} must be 0 or the number of processes "
            f"over num_depth_shards, {world} / {n_depth} = {n_data}")
    if global_batch is not None and global_batch % n_data:
        raise ValueError(
            f"a global batch of {global_batch} does not divide over the "
            f"{n_data} data shards of --num_hosts {world} with "
            f"num_depth_shards={n_depth} ({LAUNCH})")


def warp_frame(src: Tensor, depth: Tensor, T: Tensor, K: Tensor,
               inv_K: Tensor) -> Tensor:
    """Inverse-warp `src` (B, 3, H, W) into the current view by depth
    (B, 1, H, W) and pose T, with border padding
    (`manydepth/trainer.py:1111-1125`, `mal_tpu/train/step.py:32-41`)."""
    B, _, H, W = src.shape
    points = geometry.backproject(depth, inv_K, H, W)
    grid = geometry.project_3d(points, K, T, H, W)
    return grid_sample(src, grid, padding_mode="border")


def _all_photometric_warps(cfg: Config, batch: dict, outputs: dict,
                           depth_specs) -> list[list[Tensor]]:
    """Warped adjacent frames for each (depth (B, 1, H, W), detach_T) spec,
    sharing one back-projection per depth (`step.py:56-86`).

    In fast mode the frames are sampled from their bf16 roundings while the
    coordinates, the bilinear weights and the result stay fp32
    (`mal_tpu/train/step.py:67-84`). `F.grid_sample` takes one type for
    frame and grid, so the rounded frame is read back as fp32: the numbers
    of `mal_tpu`'s bf16 gather, without its halved traffic."""
    B, _, H, W = batch["color"]["0"].shape
    payload = compute_dtype_of(cfg.compute_dtype)
    out = []
    for depth, detach in depth_specs:
        points = geometry.backproject(depth, batch["inv_K"], H, W)
        warped = []
        for f in cfg.frame_ids[1:]:
            T = outputs[f"cam_T_cam/0/{f}"]
            if detach:
                T = T.detach()
            grid = geometry.project_3d(points, batch["K"], T, H, W)
            frame = batch["color"][str(f)]
            if payload is not None:
                frame = frame.to(payload).float()
            warped.append(grid_sample(frame, grid, padding_mode="border"))
        out.append(warped)
    return out


def make_loss_fn(cfg: Config, model: MALModel,
                 seg_fn: Callable | None = None) -> Callable:
    """`loss_fn(batch, min_d, max_d, balancer, epoch, aug_draw=None,
    noise=None, generator=None) -> (total, aux)`: the loss assembly of
    `Trainer.process_batch` (`manydepth/trainer.py:555-644`). Running it
    updates the BN statistics, as the forward of a training step does.

    aug_draw: (B,) uniform draw of the matching augmentation; noise:
    (B, 1, H, W) standard-normal automask tie-break draw. Each is drawn
    from `generator` when not given. `seg_fn(images (B, H, W, 3)) ->
    Instances` is the frozen segmenter of the temporal hint, required when
    `temporal` or `main_temporal` is on (`segment/mask2former.py:
    make_seg_fn`, or a test's stand-in).
    """
    check_supported(cfg, seg_fn)
    train_teacher = not cfg.freeze_teacher_and_pose
    train_pose = train_teacher and not cfg.freeze_pose
    reproj_fn = (losses.l1_reprojection_loss if cfg.no_ssim
                 else losses.reprojection_loss)
    mono_call, multi_call = losses.mono_losses, losses.multi_losses
    if cfg.remat:
        # the loss assemblies hold the step's largest full-resolution
        # intermediates (SSIM maps, automask stacks, distillation
        # composites): recompute them in the backward
        mono_call = functools.partial(remat, losses.mono_losses)
        multi_call = functools.partial(remat, losses.multi_losses)

    def temporal_syn(warped: list[Tensor], inst_cur):
        """Synthesized frames from one pair of warped frames
        (`dyn_utils.py:121-170`); the segmenter sees them detached, and
        `inst_cur` is shared between the teacher's and the student's call.
        Returns the two frames and the (B,) items with a matched pair."""
        with profiling.span("mal.synthesis"):
            inst_last, inst_next = (seg_fn(w.detach().permute(0, 2, 3, 1))
                                    for w in warped)
            syn_l, syn_n, has = image_synthesis(
                warped[0], warped[1], inst_cur, inst_last, inst_next,
                cfg.ins_threshold,
                payload_dtype=compute_dtype_of(cfg.compute_dtype))
        return [syn_l, syn_n], has

    def loss_fn(batch: dict, min_d: Tensor, max_d: Tensor,
                balancer: losses.LossBalancerState, epoch: float,
                aug_draw: Tensor | None = None, noise: Tensor | None = None,
                generator: torch.Generator | None = None):
        with profiling.span("mal.depth_model"):
            outputs = model(batch, min_d, max_d, aug_draw=aug_draw,
                            generator=generator, train=True,
                            train_teacher=train_teacher, train_pose=train_pose)
        with profiling.span("mal.losses"):
            return losses_of(batch, outputs, balancer, epoch, noise, generator)

    def losses_of(batch: dict, outputs: dict,
                  balancer: losses.LossBalancerState, epoch: float,
                  noise: Tensor | None, generator: torch.Generator | None):
        # the current frame's instances, shared by both syntheses: from the
        # precomputed cache when `seg_cache_root` is set
        # (`segment/cache.py`), else one segmenter forward
        inst_cur = None
        if cfg.temporal or cfg.main_temporal:
            inst_cur = (instances_from_batch(batch)
                        if cfg.seg_cache_root is not None
                        else seg_fn(batch["color"]["0"]))
        batch = to_nchw(batch)
        color0 = batch["color"]["0"]
        identity = [batch["color"][str(f)] for f in cfg.frame_ids[1:]]
        mono_disp = outputs["mono_disp"].permute(0, 3, 1, 2)
        disp = outputs["disp"].permute(0, 3, 1, 2)

        _, mono_depth = geometry.disp_to_depth(mono_disp, cfg.min_depth,
                                               cfg.max_depth)
        _, multi_depth = geometry.disp_to_depth(disp, cfg.min_depth,
                                                cfg.max_depth)
        depth_specs = [(mono_depth, False), (multi_depth, True)]
        use_ens = cfg.distil and cfg.use_ensemble
        if use_ens:
            disp_ens = ((mono_disp + disp) / 2.0).detach()
            _, ens_depth = geometry.disp_to_depth(disp_ens, cfg.min_depth,
                                                  cfg.max_depth)
            depth_specs.append((ens_depth, True))
        warps = _all_photometric_warps(cfg, batch, outputs, depth_specs)

        # --- teacher ---
        if noise is None and not cfg.disable_automasking:
            noise = torch.randn(mono_depth.shape, generator=generator,
                                device=mono_depth.device)
        syn_items = torch.zeros((), device=color0.device)
        mono_syn = []
        if cfg.temporal:
            mono_syn, has = temporal_syn(warps[0], inst_cur)
            syn_items = syn_items + has.sum()
        mono_out = mono_call(
            noise, mono_disp, color0, warps[0], identity, syn=mono_syn,
            smoothness_weight=cfg.disparity_smoothness, reproj_fn=reproj_fn,
            avg_reprojection=cfg.avg_reprojection,
            disable_automasking=cfg.disable_automasking)

        # --- student ---
        mono_depth_sg = mono_depth.detach()
        if cfg.disable_motion_masking:
            cmask = torch.ones_like(outputs["consistency_mask"])
        else:
            cmask = outputs["consistency_mask"] * losses.matching_mask(
                mono_depth_sg, outputs["lowest_cost"])
        ens_reproj = None
        if use_ens:
            with torch.no_grad():
                ens_reproj = losses.min_reprojection(warps[2], color0,
                                                     reproj_fn=reproj_fn)
        multi_syn = []
        if cfg.main_temporal:
            multi_syn, has = temporal_syn(warps[1], inst_cur)
            syn_items = syn_items + has.sum()
        multi_out = multi_call(
            disp, color0, warps[1], multi_depth, mono_depth_sg, cmask,
            outputs["augmentation_mask"], mono_out.min_reproj.detach(),
            syn=multi_syn,
            ensemble_min_reproj=ens_reproj,
            dual_distil_mono_depth=mono_depth if cfg.dual_distil else None,
            smoothness_weight=cfg.disparity_smoothness, reproj_fn=reproj_fn,
            avg_reprojection=cfg.avg_reprojection)

        # --- total loss (`trainer.py:624-642`) ---
        ori_loss = multi_out.loss
        if train_teacher:
            ori_loss = ori_loss + mono_out.loss
        new_balancer = balancer
        components = None
        if cfg.distil and cfg.pareto:
            # --pareto (`loss_utils.py:256-263`): the train step weighs the
            # (multi, distil) gradients by an MGDA solve; the mono loss
            # joins unweighted and doubled, as in plain distil below
            mono_term = (2.0 * mono_out.loss if train_teacher
                         else torch.zeros((), device=color0.device))
            components = torch.stack([multi_out.loss, multi_out.distil_loss,
                                      mono_term])
            total = multi_out.loss + multi_out.distil_loss + mono_term
        elif cfg.distil and cfg.loss_blc:
            lam = max(cfg.lambda_for_adjust_start
                      + float(epoch) * cfg.lambda_for_adjust_slope,
                      cfg.lambda_for_adjust_min)
            total, new_balancer = losses.loss_balance(
                balancer, torch.stack([ori_loss, multi_out.distil_loss]), lam)
            # the reference re-adds the weighted scalar once per batch item
            # (`loss_utils.py:303-312`), so the objective is B x the sum,
            # B the global batch
            total = total * (color0.shape[0] * mesh.data_shards())
        elif cfg.distil:
            # the reference's plain-distil total counts the mono loss twice
            # (aliased "loss/0" / "loss" keys, `loss_utils.py:277-279`)
            total = multi_out.loss + multi_out.distil_loss
            if train_teacher:
                total = total + 2.0 * mono_out.loss
        else:
            total = ori_loss

        aux = {
            "balancer": new_balancer,
            "mono_depth": mono_depth_sg,
            # (multi, distil, 2 mono) for the pareto step's gradient pulls
            "components": components,
            "metrics": {
                "loss": total.detach(),
                "ori_loss": ori_loss.detach(),
                "mono_reproj": mono_out.reproj_loss.detach(),
                "multi_reproj": multi_out.reproj_loss.detach(),
                "consistency_loss": multi_out.consistency_loss.detach(),
                "distil_loss": multi_out.distil_loss.detach(),
                "w_ori": new_balancer.w[0],
                "w_distil": new_balancer.w[1],
                # items whose synthesis had a matched instance pair, summed
                # over the teacher's and the student's synthesis
                "syn_items": syn_items,
            },
        }
        return total, aux

    return loss_fn


def _pareto_backward(cfg: Config, model: torch.nn.Module,
                     components: Tensor) -> dict:
    """--pareto (`mal_tpu/train/step.py:346-376`): the gradients of the
    one forward's (multi, distil, 2 mono) losses, pulled one at a time, set
    as `.grad` = w0 g_multi + w1 g_distil + g_mono with (w0, w1) the MGDA
    min-norm weights of the first two (`pareto.py`). The weights' dot
    products run over every parameter, frozen sub-nets included, as
    `mal_tpu`'s run over all of `state.params`; a parameter a loss does not
    reach has a zero gradient. In a data-parallel step the three gradients
    are summed over the ranks first, so that the products are those of the
    global batch. Returns the metrics the pareto step overrides."""
    params = list(model.parameters())
    grads = []
    for i in range(3):
        g = torch.autograd.grad(components[i], params, retain_graph=i < 2,
                                allow_unused=True)
        grads.append([torch.zeros_like(p) if gi is None else gi
                      for p, gi in zip(params, g)])
    mesh.all_reduce_([g for gs in grads for g in gs])
    g_multi, g_distil, g_mono = grads
    w0, w1 = pareto_weights_2task(g_multi, g_distil, *cfg.pareto_c)
    for p, a, b, c in zip(params, g_multi, g_distil, g_mono):
        p.grad = w0 * a + w1 * b + c
    comps = components.detach()
    weighted = w0 * comps[0] + w1 * comps[1]
    # the reference logs w0 x the already re-weighted loss as ori_loss
    # (`loss_utils.py:261` reads `loss` after line 260 rebinds it)
    return {"loss": weighted + comps[2], "w_ori": w0, "w_distil": w1,
            "ori_loss": w0 * weighted}


def make_train_step(cfg: Config, device: str | torch.device | None = None,
                    seg_fn: Callable | None = None,
                    doj_fn: Callable | None = None) -> Callable:
    """`train_step(state, batch, epoch=0.0, generator=None, draws=None)
    -> (state, metrics)` on `device` (default: the GPU, raising if there
    is none). `seg_fn` as in `make_loss_fn`. `cfg.method="dynamicdepth"`
    gives `mal_tpu_torch.dynamic.step.make_dynamic_train_step`'s step, with
    `doj_fn` the online masks of `online_doj`; `"dualrefine"`
    `mal_tpu_torch.dualref.step.make_dualref_train_step`'s.

    `draws` may hold "matching_aug" (B,) and "automask_noise" (B, 1, H, W)
    to inject the step's random draws. The learning rate of step n is the
    schedule at n, counted before the increment, as optax counts it (so
    step 0 trains at `init_lr`).

    In a process group (`parallel/distributed.py`) the step is data
    parallel over its processes: `batch` and `draws` are this process's
    shard of the global batch's, and every rank ends with the same state
    and the global batch's metrics.
    """
    if cfg.method == "dynamicdepth":
        from mal_tpu_torch.dynamic.step import make_dynamic_train_step

        return make_dynamic_train_step(cfg, device, doj_fn)
    check_supported(cfg, seg_fn)
    if cfg.method == "dualrefine":
        from mal_tpu_torch.dualref.step import make_dualref_train_step

        return make_dualref_train_step(cfg, device)
    device = resolve_device(device)
    train_teacher = not cfg.freeze_teacher_and_pose
    schedule = make_schedule(cfg)

    @data_parallel(cfg, split_planes=True)
    def train_step(state: TrainState, batch: dict, epoch: float = 0.0,
                   generator: torch.Generator | None = None,
                   draws: dict | None = None):
        if batch["K"].device != device:
            raise ValueError(f"batch is on {batch['K'].device}, the step "
                             f"runs on {device}")
        with profiling.span(profiling.STEP):
            draws = draws or {}
            model = state.model
            loss_fn = make_loss_fn(cfg, model, seg_fn)

            model.zero_grad(set_to_none=True)
            total, aux = loss_fn(batch, state.bins.min_depth,
                                 state.bins.max_depth, state.balancer, epoch,
                                 aug_draw=draws.get("matching_aug"),
                                 noise=draws.get("automask_noise"),
                                 generator=generator)
            pareto_metrics = {}
            with profiling.span("mal.backward"):
                if aux["components"] is not None:
                    pareto_metrics = _pareto_backward(cfg, model,
                                                      aux["components"])
                else:
                    total.backward()
                    mesh.all_reduce_grads(model.parameters())
            with profiling.span("mal.optimizer"):
                apply_gradients(state.optimizer, schedule(state.step),
                                cfg.grad_clip_norm)
                # adaptive depth bins from the teacher (`trainer.py:631-634`)
                if cfg.adaptive_bins and train_teacher:
                    state.bins = state.bins.update(
                        aux["mono_depth"], cfg.min_depth, cfg.depth_bin_ema)
            state.balancer = aux["balancer"]
            state.step += 1
            metrics = dict(aux["metrics"])
            metrics.update(pareto_metrics)
            # the balancer's weights are global already; the rest are shares
            metrics = mesh.sum_metrics(metrics, keep=("w_ori", "w_distil"))
            metrics["min_depth_bin"] = state.bins.min_depth
            metrics["max_depth_bin"] = state.bins.max_depth
        return state, metrics

    return train_step


def data_parallel(cfg: Config, split_planes: bool = False) -> Callable:
    """Decorator: the step run inside `parallel/mesh.py:data_axis` over the
    default process group (the plain step in one process), the ranks of a
    depth row (`cfg.num_depth_shards`) counted as replicas of their shard.
    With `split_planes` (ManyDepth) the step also runs inside this rank's
    `depth_axis`, whose group is built here, when the step is made: every
    rank makes its step at the same point. Without it (DynamicDepth,
    DualRefine, which `mal_tpu` does not split either) the depth ranks
    compute their shard's step alike."""
    n_depth = cfg.num_depth_shards if distributed.world() > 1 else 1
    row = (distributed.depth_row(n_depth) if split_planes and n_depth > 1
           else None)

    def wrap(train_step: Callable) -> Callable:
        @functools.wraps(train_step)
        def step(*args, **kwargs):
            with contextlib.ExitStack() as stack:
                stack.enter_context(
                    mesh.data_axis(distributed.world(), replicas=n_depth))
                if row is not None:
                    stack.enter_context(mesh.depth_axis(*row))
                return train_step(*args, **kwargs)

        return step

    return wrap
