"""Host-side training orchestration (the port's counterpart of
`mal_tpu.train.trainer`).

The loop around the training step, replacing `manydepth/trainer.py:
119-1730`: the model on one device, metric logging, the step-250 early
validation and the periodic validation (`trainer.py:498-537`), per-epoch
loss-balancer resets, checkpoints and resume. The numerical work lives in
`mal_tpu_torch.train.step`, `mal_tpu_torch.dynamic.step` and
`mal_tpu_torch.dualref.step`. DualRefine also keeps its own cadence: from
`freeze_teacher_epoch` only the refinement student trains, and a
checkpoint is saved at the end of every `save_frequency`-th epoch.

In a process group (`parallel/distributed.py`, one process per card)
every process trains on its loader's shard: the state is broadcast from
rank 0 once, the step is data parallel (`train/step.py`), each data
shard's draws come from its own generator (`rank_seed` of the data index:
the ranks of a depth row draw alike), and only rank 0 logs, validates and
writes checkpoints; every rank's state stays the same.

The loader yields numpy batches; each goes to the card through pinned
memory with `non_blocking=True`. The trainer records, per step, how long it
waited on the loader (`loader_wait_s`) and the host time from asking for
the batch to the step's return (`step_s`; it includes the device's work
only on steps whose metrics are logged, which wait for the device).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable, Mapping

import numpy as np
import torch

from mal_tpu_torch.config import Config
from mal_tpu_torch.device import batch_to_device, resolve_device
from mal_tpu_torch.eval.evaluate import evaluate_depth_maps, infer_disparities
from mal_tpu_torch.parallel import distributed, mesh
from mal_tpu_torch.train.state import create_train_state, make_optimizer
from mal_tpu_torch.train.step import make_train_step
from mal_tpu_torch.utils.checkpoint import save_checkpoint
from mal_tpu_torch.utils.misc import sec_to_hm_str


class MetricLogger:
    """Console / callback logger (wandb-compatible dict stream)."""

    def __init__(self, sink: Callable[[dict, int], None] | None = None):
        self.sink = sink
        self.history: list[tuple[int, dict]] = []

    def log(self, metrics: dict, step: int):
        scalars = {k: float(v) for k, v in metrics.items()}
        self.history.append((step, scalars))
        if self.sink is not None:
            self.sink(scalars, step)
        else:
            parts = " ".join(f"{k}={v:.4f}" for k, v in sorted(scalars.items()))
            print(f"[step {step}] {parts}", flush=True)


def _default_sink(cfg: Config):
    """Console and JSONL under ckpt_dir, plus wandb when the environment is
    set up for it (the reference's sink, `manydepth/trainer.py:110,472-492`,
    project `plug_many`)."""
    from mal_tpu_torch.utils.logging import (console_sink, jsonl_sink,
                                             multi_sink, wandb_sink)

    sinks = [console_sink]
    if cfg.ckpt_dir:
        try:
            sinks.append(jsonl_sink(os.path.join(cfg.ckpt_dir, "metrics.jsonl")))
        except OSError:
            pass
    if os.environ.get("WANDB_API_KEY") or os.environ.get("WANDB_MODE"):
        try:
            sinks.append(wandb_sink(name=cfg.model_name,
                                    config=json.loads(cfg.to_json())))
        except Exception as e:  # wandb missing or offline: keep training
            print(f"wandb sink disabled: {e}", flush=True)
    return multi_sink(*sinks)


def _no_sink(metrics: dict, step: int) -> None:
    """The sink of a rank other than 0, which logs nothing."""


class Trainer:
    """Training on one device: the card unless `device="cpu"` is passed.

    `seg_state` is the frozen Mask2Former's detectron2 state dict (from
    `mal_tpu_torch.convert.mask2former.load_pkl`), required when
    `cfg.temporal` / `cfg.main_temporal` is on, or DynamicDepth's
    `cfg.online_doj`; the segmenter is a Swin-L
    Mask2Former, in fast mode with bf16 blocks (and K2 / K3 on the card).
    Weights are drawn from `seed` (not with `init_weights=False`, for a
    trainer that resumes next), and so are the step's random draws."""

    def __init__(self, cfg: Config, train_loader: Iterable,
                 val_batches: Iterable | None = None,
                 gt_depths: list | None = None,
                 logger: MetricLogger | None = None,
                 seed: int = 0,
                 seg_state: Mapping[str, np.ndarray] | None = None,
                 device: str | torch.device | None = None,
                 init_weights: bool = True):
        if cfg.height % 32 or cfg.width % 32:
            raise ValueError(f"height and width must be multiples of 32, got "
                             f"{cfg.height}x{cfg.width}")
        if cfg.lr_scheduler == "step" and cfg.steps_per_epoch == 0:
            # the per-epoch StepLR schedule needs the epoch length in steps
            try:
                cfg = cfg.replace(steps_per_epoch=len(train_loader))
            except TypeError:
                raise ValueError(
                    "lr_scheduler='step' with an unsized train_loader: set "
                    "Config.steps_per_epoch explicitly") from None
        self.cfg = cfg
        self.device = resolve_device(device)
        self.train_loader = train_loader
        self.val_batches = val_batches
        self.gt_depths = gt_depths
        # one process per card: rank 0 alone logs (a wandb run and a
        # metrics.jsonl for the job, not one a process), validates and saves
        self.rank = distributed.rank()
        self.logger = logger or MetricLogger(
            sink=_default_sink(cfg) if self.rank == 0 else _no_sink)

        # the frozen Mask2Former: for the MAL temporal hint
        # (`manydepth/trainer.py:350-357`) and for the online dynamic-object
        # masks (`online_doj`, `segment/doj.py`)
        seg_fn = doj_fn = None
        online_doj = cfg.method == "dynamicdepth" and cfg.online_doj
        if cfg.temporal or cfg.main_temporal or online_doj:
            if seg_state is None:
                # the reference always builds the segmenter from pretrained
                # COCO weights (`manydepth/options.py:288-295`); a random
                # Mask2Former would make the hint synthesize noise
                raise ValueError(
                    "cfg.temporal / main_temporal / online_doj requires "
                    "pretrained Mask2Former weights: pass seg_state (see "
                    "mal_tpu_torch.convert.mask2former.load_pkl)")
            from mal_tpu_torch.convert.mask2former import load_mask2former_state
            from mal_tpu_torch.segment.mask2former import (
                Mask2Former, make_seg_fn, resolve_fused_swin)

            self.seg_model = Mask2Former(
                device=self.device,
                bf16_backbone=cfg.compute_dtype == "bfloat16",
                fused_swin=resolve_fused_swin(cfg, self.device),
                init_weights=False)
            load_mask2former_state(self.seg_model, seg_state)
            if cfg.temporal or cfg.main_temporal:
                seg_fn = make_seg_fn(self.seg_model, cfg.max_instances)
            if online_doj:
                from mal_tpu_torch.segment.doj import make_doj_fn

                doj_fn = make_doj_fn(self.seg_model, cfg.max_instances,
                                     score_threshold=cfg.ins_threshold)
        # raises for the options not yet ported (`check_supported`)
        self.step_fn = make_train_step(cfg, self.device, seg_fn=seg_fn,
                                       doj_fn=doj_fn)
        self.state = create_train_state(
            cfg, self.device, generator=torch.Generator().manual_seed(seed),
            init_weights=init_weights)
        self.model = self.state.model
        # rank 0's state everywhere
        mesh.broadcast_state(self.state)
        self.generator = torch.Generator(device=self.device).manual_seed(
            distributed.rank_seed(
                seed, distributed.grid(cfg.num_depth_shards).data_index))
        self.step = 0
        self.loader_wait_s: list[float] = []
        self.step_s: list[float] = []
        self.start_time = time.time()

    def load_pretrained(self, folder: str,
                        models_to_load: tuple[str, ...] | None = None,
                        bins: bool = True) -> list[str]:
        """Initialise sub-nets from a reference-layout `.pth` directory
        before training (`--load_pretrained` / `--mono_weights_folder`,
        `repdepth.py:76-99`, `manydepth/trainer.py:1638-1655`), with the
        depth bins of `encoder.pth` when `bins`. Adam's moments start
        fresh, as in the reference's `load_manydepth`. DualRefine loads its
        whole model from `depth_pose.pth`, with the four bin statistics."""
        from mal_tpu_torch.utils.checkpoint import load_pretrained

        if self.cfg.method == "dualrefine":
            from mal_tpu_torch.convert.dualref import \
                load_dualrefine_checkpoint_dir

            extras = load_dualrefine_checkpoint_dir(self.model, folder)
            if bins:
                self.state.bins.load(extras)
            loaded = ["depth_pose"]
        else:
            loaded = load_pretrained(self.model, folder, models_to_load,
                                     bins=self.state.bins if bins else None)
        print(f"loaded pretrained nets {loaded} from {folder}", flush=True)
        return loaded

    def load_imagenet(self, path: str) -> None:
        """`--weights_init pretrained`: the ResNet-18 trunks from a
        torchvision ImageNet state dict (`.pth`), `trainer.py:250-301`."""
        if self.cfg.method == "dualrefine":
            raise NotImplementedError(
                "dualrefine uses HRNet encoders, which the torchvision "
                "resnet layout does not fit; initialise from a depth_pose.pth "
                "with --load_pretrained")
        if self.cfg.num_layers != 18:
            raise NotImplementedError(
                "single-file ImageNet init assumes resnet18 everywhere (the "
                f"reference's default); got num_layers={self.cfg.num_layers}")
        from mal_tpu_torch.utils.checkpoint import load_imagenet_trunks

        sd = torch.load(path, map_location="cpu", weights_only=True)
        load_imagenet_trunks(self.model, sd, self.cfg.pose_cnn)
        print(f"ImageNet trunk init from {path}", flush=True)

    def resume(self, ckpt_path: str) -> int:
        """Restore a saved state and continue mid-run. Accepts a
        `step_NNNNNNNN` path or its parent (the latest step is taken)."""
        from mal_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                    load_checkpoint)

        if not os.path.basename(ckpt_path.rstrip("/")).startswith("step_"):
            latest = latest_checkpoint(ckpt_path)
            if latest is None:
                raise FileNotFoundError(
                    f"no step_* checkpoint under {ckpt_path}")
            ckpt_path = latest
        load_checkpoint(ckpt_path, self.state)
        mesh.broadcast_state(self.state)
        self.step = self.state.step
        return self.step

    # ------------------------------------------------------------------
    def train(self, start_epoch: int = 0):
        """`start_epoch` > 0 resumes mid-run: epoch-keyed schedules (the
        loss_blc lambda annealing, DualRefine's freeze epoch and
        save_frequency) see the true epoch index."""
        for epoch in range(start_epoch, self.cfg.num_epochs):
            self.run_epoch(epoch)
        return self.state

    def run_epoch(self, epoch: int):
        cfg = self.cfg
        dualrefine = cfg.method == "dualrefine"
        if dualrefine and epoch == cfg.freeze_teacher_epoch and epoch > 0:
            # DualRefine's freeze (`dualrefine/trainer.py:207-213`): only
            # the refinement student trains on, with a new optimizer (Adam's
            # moments restart), as `mal_tpu/train/trainer.py:333-344`
            self.state.optimizer = make_optimizer(cfg, self.model,
                                                  freeze_backbone=True)
            self.state.frozen_backbone = True
        # the loss balancer's cumulative window resets per epoch
        # (`loss_utils.py:294,321`)
        self.state.balancer = self.state.balancer.reset_epoch()
        it = (self.train_loader.epoch(epoch)
              if hasattr(self.train_loader, "epoch")
              else iter(self.train_loader))
        while True:
            t0 = time.perf_counter()
            try:
                host = next(it)
            except StopIteration:
                break
            self.loader_wait_s.append(time.perf_counter() - t0)
            batch = batch_to_device(host, self.device)
            self.state, metrics = self.step_fn(self.state, batch, float(epoch),
                                               self.generator)
            if self.rank == 0 and self.step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["lr_step"] = self.step
                m["elapsed"] = time.time() - self.start_time
                self.logger.log(m, self.step)
            self.step_s.append(time.perf_counter() - t0)

            early = self.step == 250
            # periodic validation gated by --validate_from
            # (`manydepth/trainer.py:514`)
            periodic = (self.step != 0 and self.step % cfg.validate_every == 0
                        and self.step > cfg.validate_from)
            if ((early or periodic) and self.val_batches is not None
                    and self.rank == 0):
                results = self.validate()
                self.logger.log({f"val/{k}": v for k, v in results.items()},
                                self.step)
                # --save_until: checkpoints only from that step on
                # (`manydepth/trainer.py:536`)
                if periodic and cfg.ckpt_dir and self.step >= cfg.save_until:
                    save_checkpoint(os.path.join(
                        cfg.ckpt_dir, f"{cfg.model_name}_s{self.step}"),
                        self.state, cfg)
            self.step += 1

        # DualRefine's end-of-epoch save (`dualrefine/trainer.py:219`; the
        # other methods save at validation)
        if (dualrefine and cfg.ckpt_dir and cfg.save_frequency > 0
                and (epoch + 1) % cfg.save_frequency == 0 and self.rank == 0):
            save_checkpoint(os.path.join(
                cfg.ckpt_dir, f"{cfg.model_name}_e{epoch}"), self.state, cfg)
        print(f"epoch {epoch} done at step {self.step} "
              f"({sec_to_hm_str(time.time() - self.start_time)})", flush=True)

    # ------------------------------------------------------------------
    def validate(self) -> dict:
        """Full eval-split validation (`manydepth/trainer.py:836-1064`)."""
        bins = self.state.bins
        min_bin, max_bin = float(bins.min_depth), float(bins.max_depth)
        if self.cfg.method == "dynamicdepth":
            # the eval_mode protocol, with the doj metric families
            from mal_tpu_torch.dynamic.evaluate import evaluate_dynamic

            if self.gt_depths is None:
                return {"n_images": float(len(self.val_batches))}
            return evaluate_dynamic(self.cfg, self.model, self.val_batches,
                                    self.gt_depths, min_bin, max_bin,
                                    device=self.device)
        if self.cfg.method == "dualrefine":
            from mal_tpu_torch.dualref.evaluate import infer_disparities_dualref

            disps = infer_disparities_dualref(self.model, self.val_batches,
                                              self.cfg, device=self.device)
        else:
            disps = infer_disparities(self.model, self.val_batches, self.cfg,
                                      min_depth_bin=min_bin,
                                      max_depth_bin=max_bin,
                                      device=self.device)
        if self.cfg.log_disp_images > 0 and self.cfg.ckpt_dir:
            from mal_tpu_torch.utils.vis import dump_disp_images

            dump_disp_images(disps, os.path.join(self.cfg.ckpt_dir, "images"),
                             self.step, n=self.cfg.log_disp_images)
        if self.gt_depths is None:
            return {"n_images": float(len(disps))}
        return evaluate_depth_maps(disps, self.gt_depths,
                                   eval_split=self.cfg.eval_split)
