"""Command-line entry points of the port (counterpart of `mal_tpu.cli`).

    python -m mal_tpu_torch.cli train --preset kitti --data_path ...
    python -m mal_tpu_torch.cli eval --ckpt ... --data_path ... --gt gt_depths.npz
    python -m mal_tpu_torch.cli export-pth --ckpt ... --out ...
    python -m mal_tpu_torch.cli export-seg --seg_pkl ... --out ... --data_path ...
    python -m mal_tpu_torch.cli finetune-seg --images ... --annotations ... --out ...

The flags are `mal_tpu.cli`'s, plus `--device` (default `cuda`, which raises
when no card is present; `--device cpu` runs the plain PyTorch path).
`train --coordinator host:port --num_hosts N --host_id i`, run once per
process, trains data parallel over N processes, one per card (in the
port the flags count processes, not hosts; `parallel/distributed.py`);
with `--set num_depth_shards=n` (n dividing N) the N processes form N / n
data shards of n ranks each, which split the cost volume's planes. Any
Config field can be overridden with `--set key=value`. Split files resolve
against the working directory (`splits/<split>/train_files.txt`, ...).
`main` returns what the command made: the `Trainer` of `train`, the metrics
of `eval`, the written paths of `export-pth`, the number of files
`export-seg` wrote, the step metrics, mask AP and written paths of
`finetune-seg`.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

import numpy as np

from mal_tpu_torch.config import PRESETS, TRAIN_FAST_SETTINGS, Config


def _apply_overrides(cfg: Config, pairs: list[str]) -> Config:
    updates = {}
    for pair in pairs:
        key, value = pair.split("=", 1)
        try:
            updates[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            updates[key] = value
    return cfg.replace(**updates)


def _img_ext(cfg: Config) -> str:
    return ".png" if cfg.png else ".jpg"


def _train_dataset(cfg: Config, seg_cache_root: str | None):
    """The training split's dataset (`splits/<split>/train_files.txt`)."""
    from mal_tpu_torch.data.cityscapes import CityscapesPreprocessedDataset
    from mal_tpu_torch.data.kitti import KITTIRAWDataset
    from mal_tpu_torch.utils.misc import readlines

    datasets = {"kitti": KITTIRAWDataset,
                "cityscapes_preprocessed": CityscapesPreprocessedDataset}
    train_files = readlines(os.path.join("splits", cfg.split,
                                         "train_files.txt"))
    return datasets[cfg.dataset](cfg.data_path, train_files, cfg.height,
                                 cfg.width, cfg.frames_to_load, is_train=True,
                                 img_ext=_img_ext(cfg),
                                 seg_cache_root=seg_cache_root)


def build_train_loader(cfg: Config, shard: tuple[int, int] = (0, 1)):
    """The training loader: the threaded native decode with background
    prefetch (`mal_tpu/cli.py:34-64`) when `cfg.native_loader` is on and
    `libmalio.so` builds, else the PIL loader; `shard` (data index, data
    shards) is the process's share of the split. Prints which one runs, and why the
    native one does not."""
    from mal_tpu_torch.data.mono_dataset import DataLoader

    ds = _train_dataset(cfg, cfg.seg_cache_root)
    if cfg.native_loader:
        from mal_tpu_torch.data import native
        from mal_tpu_torch.data.fast_loader import NativePrefetchLoader

        if not native.available():
            print(f"loader: PIL (the native library is unavailable: "
                  f"{native.build_error()})", flush=True)
        elif not hasattr(ds, "get_image_path"):
            print(f"loader: PIL ({type(ds).__name__} has no image paths for "
                  f"the native loader)", flush=True)
        else:
            print("loader: native (libmalio, threaded decode, prefetch 2)",
                  flush=True)
            return NativePrefetchLoader(ds, cfg.batch_size, shuffle=True,
                                        drop_last=True, shard=shard,
                                        num_threads=max(cfg.num_workers, 1))
    else:
        print("loader: PIL (native_loader=False)", flush=True)
    return DataLoader(ds, cfg.batch_size, shuffle=True, drop_last=True,
                      shard=shard)


def build_eval_loader(cfg: Config, data_path: str, frames=(0, -1),
                      doj_root: str | None = None,
                      batch_size: int | None = None):
    from mal_tpu_torch.data.cityscapes import CityscapesEvalDataset
    from mal_tpu_torch.data.kitti import KITTIRAWDataset
    from mal_tpu_torch.data.mono_dataset import DataLoader
    from mal_tpu_torch.utils.misc import readlines

    files = readlines(os.path.join("splits", cfg.eval_split, "test_files.txt"))
    if cfg.eval_split == "cityscapes":
        ds = CityscapesEvalDataset(data_path, files, cfg.height, cfg.width,
                                   list(frames), is_train=False)
    else:
        ds = KITTIRAWDataset(data_path, files, cfg.height, cfg.width,
                             list(frames), is_train=False,
                             img_ext=_img_ext(cfg))
    if doj_root:
        from mal_tpu_torch.data.doj import attach_doj_masks
        ds = attach_doj_masks(ds, doj_root)
    return DataLoader(ds, batch_size or cfg.batch_size, shuffle=False,
                      drop_last=False)


def cmd_train(args):
    cfg = PRESETS[args.preset].replace(data_path=args.data_path)
    # fast-training defaults (overridable with --set compute_dtype=...)
    cfg = cfg.replace(**TRAIN_FAST_SETTINGS)
    cfg = _apply_overrides(cfg, args.set or [])
    from mal_tpu_torch.parallel import distributed
    from mal_tpu_torch.train.step import check_parallel

    world, rank = args.num_hosts, args.host_id
    check_parallel(cfg, world)       # before any process joins a group
    device = args.device
    if args.coordinator:
        # one process per card (the reference's `accelerate launch
        # --multi_gpu`); run this command once per process
        device = distributed.rank_device(args.device, rank)
        distributed.initialize(distributed.coordinator_url(args.coordinator),
                               world, rank, device=device)
    elif world != 1 or rank != 0:
        raise ValueError("--num_hosts and --host_id need --coordinator "
                         "host:port")
    g = distributed.grid(cfg.num_depth_shards, world, rank)
    try:
        # the ranks of a depth row read the same shard
        return _train(args, cfg, device, (g.data_index, g.n_data))
    finally:
        if args.coordinator:
            distributed.shutdown()


def _train(args, cfg: Config, device, shard: tuple[int, int]):
    from mal_tpu_torch.eval.evaluate import load_gt_depths
    from mal_tpu_torch.train.trainer import Trainer

    seg_state = None
    if args.seg_pkl:
        # the frozen Mask2Former of the temporal hint and of the online
        # dynamic-object masks (the reference's --ins_weight_path COCO
        # checkpoint, `manydepth/options.py:288-295`)
        from mal_tpu_torch.convert.mask2former import load_pkl
        seg_state = load_pkl(args.seg_pkl)

    # the validation loader from the eval split (`manydepth/trainer.py:
    # 283,299-316`); checkpoints are written only at validation
    val_batches = gt_depths = None
    if not args.no_eval:
        if os.path.isfile(os.path.join("splits", cfg.eval_split,
                                       "test_files.txt")):
            dynamic = cfg.method == "dynamicdepth"
            val_batches = build_eval_loader(
                cfg, args.eval_data_path or args.data_path,
                frames=(0, -1, 1) if dynamic else (0, -1),
                batch_size=1 if dynamic else cfg.batch_size)
            if args.gt:
                gt_depths = load_gt_depths(args.gt)

    trainer = Trainer(cfg, build_train_loader(cfg, shard),
                      val_batches=val_batches, gt_depths=gt_depths,
                      seg_state=seg_state, device=device,
                      init_weights=not args.resume)   # resume overwrites
    if args.imagenet_ckpt:
        # applied first: the checkpoint loads below overwrite it, as in the
        # reference's construct-then-load order
        trainer.load_imagenet(args.imagenet_ckpt)
    if args.load_pretrained:
        trainer.load_pretrained(
            args.load_pretrained,
            models_to_load=(tuple(args.models_to_load)
                            if args.models_to_load else None))
    if args.mono_ckpt:
        # --mono_weights_folder: teacher and pose nets only
        trainer.load_pretrained(
            args.mono_ckpt, bins=False,
            models_to_load=("mono_encoder", "mono_depth", "pose_encoder",
                            "pose"))
    start_epoch = 0
    if args.resume:
        resumed_step = trainer.resume(args.resume)
        # continue from the interrupted epoch, so that epoch-keyed
        # schedules line up
        start_epoch = resumed_step // len(trainer.train_loader)
    trainer.train(start_epoch=start_epoch)
    return trainer


def load_train_state(ckpt: str, overrides: list[str], device):
    """The port's resumable checkpoint for inference: `ckpt` is a
    `step_NNNNNNNN` directory or its parent (the latest step is taken);
    its `config.json` gives the model, `--set` overrides still apply.
    Returns (cfg, state)."""
    from mal_tpu_torch.train.state import create_train_state
    from mal_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                load_checkpoint, load_config)

    if os.path.basename(ckpt.rstrip("/")).startswith("step_"):
        step_path, cfg_dir = ckpt, os.path.dirname(ckpt.rstrip("/"))
    else:
        step_path, cfg_dir = latest_checkpoint(ckpt), ckpt
        if step_path is None:
            raise SystemExit(f"no step_* checkpoint under {ckpt}")
    cfg = _apply_overrides(load_config(cfg_dir), overrides)
    state = load_checkpoint(step_path, create_train_state(
        cfg, device, init_weights=False))
    return cfg, state


def _is_pth(path: str) -> bool:
    return path.endswith(".pth") or (
        os.path.isdir(path) and any(f.endswith(".pth") for f in os.listdir(path)))


def cmd_export_pth(args):
    """The port's checkpoint as the reference's per-net `.pth` files
    (`repdepth.py:76-99`, `dynamicdepth/trainer.py:1380-1407`), or for
    DualRefine one `depth_pose.pth` with the four bin statistics and the
    training size (`dualrefine/evaluate_depth.py:105-149`)."""
    from mal_tpu_torch.utils.checkpoint import export_checkpoint_dir

    cfg, state = load_train_state(args.ckpt, args.set or [], args.device)
    if cfg.method == "dualrefine":
        from mal_tpu_torch.convert.dualref import \
            export_dualrefine_checkpoint_dir

        bins = state.bins
        paths = [export_dualrefine_checkpoint_dir(state.model, args.out, {
            "min_depth_bin": float(bins.min_depth),
            "max_depth_bin": float(bins.max_depth),
            "mean_depth_bin": float(bins.mean_depth),
            "median_depth_bin": float(bins.median_depth),
            "height": cfg.height, "width": cfg.width})]
        print("\n".join(paths))
        return paths
    paths = export_checkpoint_dir(
        state.model, args.out, float(state.bins.min_depth),
        float(state.bins.max_depth), cfg.height, cfg.width)
    print("\n".join(paths))
    return paths


def cmd_eval(args):
    cfg = _apply_overrides(PRESETS[args.preset], args.set or [])

    # stereo-trained models: fixed baseline scale, no median scaling
    # (`manydepth/evaluate_depth.py:32,245-247`)
    scale_factor = args.pred_depth_scale_factor
    median_scaling = not args.disable_median_scaling
    if args.eval_stereo:
        from mal_tpu_torch.eval.postprocess import STEREO_SCALE_FACTOR
        scale_factor = STEREO_SCALE_FACTOR
        median_scaling = False

    if args.ext_disp_to_eval:
        # saved predictions, without running the model
        from mal_tpu_torch.eval.postprocess import load_ext_disps
        return _finish_eval(args, cfg, load_ext_disps(args.ext_disp_to_eval),
                            median_scaling, scale_factor)
    if not args.ckpt:
        raise SystemExit("--ckpt is required unless --ext_disp_to_eval")

    from mal_tpu_torch.eval.evaluate import infer_disparities

    if _is_pth(args.ckpt):
        from mal_tpu_torch.train.state import DepthBinTracker
        from mal_tpu_torch.utils.checkpoint import load_pretrained

        if cfg.method == "dynamicdepth":
            # batch size 1: the reference's eval_mode indexes GT and doj
            # masks per batch (`dynamicdepth/trainer.py:1177,1228-1230`)
            from mal_tpu_torch.dynamic.evaluate import run_dynamic_eval

            _need_gt(args)
            loader = build_eval_loader(cfg, args.data_path, (0, -1, 1),
                                       doj_root=args.doj_root, batch_size=1)
            return _print(run_dynamic_eval(cfg, args.ckpt, loader, args.gt,
                                           device=args.device))
        folder = args.ckpt if os.path.isdir(args.ckpt) else \
            os.path.dirname(args.ckpt)
        if cfg.method == "dualrefine":
            # one depth_pose.pth; its training size replaces the preset's
            # (`dualrefine/evaluate_depth.py:105-125`)
            from mal_tpu_torch.convert.dualref import \
                load_dualrefine_checkpoint_dir
            from mal_tpu_torch.dualref.model import DEQDepthPose

            model = DEQDepthPose(cfg, device=args.device, init_weights=False)
            extras = load_dualrefine_checkpoint_dir(model, folder)
            if "height" in extras:
                cfg = cfg.replace(height=int(extras["height"]),
                                  width=int(extras["width"]))
            return _eval_dualref(args, cfg, model, median_scaling,
                                 scale_factor)
        from mal_tpu_torch.models import MALModel

        model = MALModel(cfg, device=args.device, init_weights=False)
        bins = DepthBinTracker.create()
        load_pretrained(model, folder, bins=bins)
    else:
        cfg, state = load_train_state(args.ckpt, args.set or [], args.device)
        model, bins = state.model, state.bins
        if cfg.method == "dynamicdepth":
            from mal_tpu_torch.dynamic.evaluate import evaluate_dynamic
            from mal_tpu_torch.eval.evaluate import load_gt_depths

            _need_gt(args)
            loader = build_eval_loader(cfg, args.data_path, (0, -1, 1),
                                       doj_root=args.doj_root, batch_size=1)
            return _print(evaluate_dynamic(
                cfg, model, iter(loader), load_gt_depths(args.gt),
                float(bins.min_depth), float(bins.max_depth),
                device=args.device))
        if cfg.method == "dualrefine":
            return _eval_dualref(args, cfg, model, median_scaling,
                                 scale_factor)
    loader = build_eval_loader(cfg, args.data_path)
    disps = infer_disparities(
        model, iter(loader), cfg, eval_teacher=args.eval_teacher,
        min_depth_bin=float(bins.min_depth),
        max_depth_bin=float(bins.max_depth),
        zero_cost_volume=args.zero_cost_volume,
        static_camera=args.static_camera, post_process=args.post_process,
        device=args.device)
    return _finish_eval(args, cfg, disps, median_scaling, scale_factor)


def _eval_dualref(args, cfg, model, median_scaling, scale_factor):
    """DualRefine's inference over the eval split
    (`dualrefine/evaluate_depth.py:67-317`), then the shared metrics."""
    from mal_tpu_torch.dualref.evaluate import infer_disparities_dualref

    disps = infer_disparities_dualref(
        model, iter(build_eval_loader(cfg, args.data_path)), cfg,
        device=args.device)
    return _finish_eval(args, cfg, disps, median_scaling, scale_factor)


def _need_gt(args) -> None:
    if not args.gt:
        raise SystemExit("dynamicdepth eval needs --gt (the eval_mode "
                         "protocol computes doj metrics against GT)")


def _print(results: dict) -> dict:
    print(json.dumps(results, indent=2))
    return results


def _finish_eval(args, cfg, disps, median_scaling, scale_factor):
    from mal_tpu_torch.eval.evaluate import (evaluate_depth_maps,
                                             load_gt_depths)

    if args.save_pred_disps:
        from mal_tpu_torch.eval.postprocess import save_pred_disps
        folder = "."
        if args.ckpt:
            folder = args.ckpt if os.path.isdir(args.ckpt) else \
                os.path.dirname(args.ckpt) or "."
        path = save_pred_disps(disps, folder, cfg.eval_split,
                               eval_teacher=args.eval_teacher,
                               zero_cost_volume=args.zero_cost_volume)
        print(f"saved predicted disparities: {path}")
    if args.no_eval:
        print("evaluation disabled (--no_eval)")
        return None
    if cfg.eval_split == "benchmark":
        # KITTI benchmark submission export, no local GT
        # (`dualrefine/evaluate_depth.py:218-233`)
        from mal_tpu_torch.eval.postprocess import export_benchmark_predictions
        out_dir = os.path.join(os.path.dirname(args.gt) if args.gt else ".",
                               "benchmark_predictions")
        n = export_benchmark_predictions(np.asarray(disps), out_dir)
        print(f"exported {n} benchmark predictions to {out_dir}")
        return None
    if not args.gt:
        raise SystemExit("--gt is required unless --no_eval or "
                         "eval_split=benchmark")
    return _print(evaluate_depth_maps(
        disps, load_gt_depths(args.gt), eval_split=cfg.eval_split,
        median_scaling=median_scaling, pred_depth_scale_factor=scale_factor))


def _sync(device) -> None:
    """Wait for `device`'s work, so that the host clock times it."""
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def cmd_finetune_seg(args):
    """Fine-tune the Mask2Former segmenter on a COCO-format dataset
    (`mal_tpu/cli.py:419-493`; the reference trains it through detectron2's
    `train_net.py`): AdamW steps on the deep-supervised set criterion with
    the colour-correct RGB input, then mask AP on the training set with
    the eval forward (kernels K4 / K5 on the card) under `no_grad`, then
    with `--out` the model as `model.pkl` (detectron2's layout, which
    `--seg_pkl` and `mal_tpu`'s converter read) and `seg_state.pt` (the
    port's state dict, in place of `mal_tpu`'s flax msgpack). Returns
    {"steps": [metrics with the step's ms and the matching's host ms],
    "eval_ms": [ms a forward of the AP pass], "AP": ..., "saved": [paths]}."""
    import time

    import torch

    from mal_tpu_torch.convert.mask2former import (export_mask2former_pkl,
                                                   load_mask2former_pkl)
    from mal_tpu_torch.device import resolve_device
    from mal_tpu_torch.segment.coco import CocoInstanceDataset
    from mal_tpu_torch.segment.criterion import CriterionConfig
    from mal_tpu_torch.segment.evaluation import evaluate_instances
    from mal_tpu_torch.segment.finetune import (make_optimizer,
                                                make_seg_finetune_step)
    from mal_tpu_torch.segment.mask2former import (Mask2Former,
                                                   instance_inference)

    device = resolve_device(args.device)
    ds = CocoInstanceDataset(args.annotations, args.images, args.height,
                             args.width, max_instances=args.max_instances)
    model = Mask2Former(num_classes=ds.num_classes, swin_size=args.size,
                        num_queries=args.num_queries, device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        init_weights=not args.seg_pkl, bgr_input=False
                        ).requires_grad_(True)
    if args.seg_pkl:
        load_mask2former_pkl(model, args.seg_pkl)
    step = make_seg_finetune_step(
        model, make_optimizer(model, args.lr, args.weight_decay),
        CriterionConfig(num_classes=ds.num_classes,
                        num_points=args.num_points))
    generator = torch.Generator(device=device).manual_seed(args.seed)

    history = []
    for epoch in range(args.epochs):
        for images, labels, masks, valid in ds.batches(
                args.batch_size, seed=args.seed + epoch, device=device):
            t0 = time.perf_counter()
            m = step(images, labels, masks, valid, generator=generator)
            m = {k: float(v) for k, v in m.items()}
            _sync(device)
            m["ms"] = 1e3 * (time.perf_counter() - t0)
            history.append(m)
            print(f"epoch {epoch} step {len(history)}: "
                  + " ".join(f"{k}={v:.4f}" for k, v in m.items()),
                  flush=True)

    # mask AP on the training set (no val split in the minimal CLI)
    preds, gts, eval_ms = [], [], []
    with torch.no_grad():
        for images, labels, masks, valid in ds.batches(
                args.batch_size, shuffle=False, device=device):
            t0 = time.perf_counter()
            logits, pmasks = model(images)
            inst = instance_inference(logits, pmasks, args.height, args.width,
                                      args.max_instances)
            _sync(device)
            eval_ms.append(1e3 * (time.perf_counter() - t0))
            for b in range(images.shape[0]):
                preds.append({"masks": inst.masks[b].cpu().numpy(),
                              "scores": inst.scores[b].cpu().numpy(),
                              "classes": inst.classes[b].cpu().numpy()})
                nb = int(valid[b].sum())
                gts.append({"masks": masks[b, :nb].cpu().numpy(),
                            "classes": labels[b, :nb].cpu().numpy()})
    ap = evaluate_instances(preds, gts)
    print(json.dumps({"AP": ap}, indent=2))

    saved = []
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        saved.append(os.path.join(args.out, "seg_state.pt"))
        torch.save(model.state_dict(), saved[0])
        saved.append(export_mask2former_pkl(
            model, os.path.join(args.out, "model.pkl")))
        print("\n".join(f"saved: {p}" for p in saved))
    return {"steps": history, "eval_ms": eval_ms, "AP": ap, "saved": saved}


def cmd_export_seg(args):
    """The temporal hint's current-frame instances for the training split
    (`segment/cache.py`): one frozen-segmenter forward per frame and
    orientation, written once and read every epoch by `train --set
    seg_cache_root=...`. Returns the number of files written."""
    from mal_tpu_torch.convert.mask2former import (load_mask2former_state,
                                                   load_pkl)
    from mal_tpu_torch.segment.cache import export_split_instances
    from mal_tpu_torch.segment.mask2former import (Mask2Former, make_seg_fn,
                                                   resolve_fused_swin)

    cfg = PRESETS[args.preset].replace(data_path=args.data_path)
    # the preset's precision, not train's fast-mode default (as mal_tpu)
    cfg = _apply_overrides(cfg, args.set or [])
    ds = _train_dataset(cfg, None)
    model = Mask2Former(swin_size=args.size, device=args.device,
                        bf16_backbone=cfg.compute_dtype == "bfloat16",
                        fused_swin=resolve_fused_swin(cfg, args.device),
                        init_weights=False)
    load_mask2former_state(model, load_pkl(args.seg_pkl))
    n = export_split_instances(ds, make_seg_fn(model, cfg.max_instances),
                               args.out, batch_size=cfg.batch_size,
                               device=args.device)
    print(f"export-seg: wrote {n} frame-instance files to {args.out}")
    return n


def main(argv=None):
    p = argparse.ArgumentParser("mal_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(parser):
        parser.add_argument("--device", default="cuda",
                            help="torch device (default cuda, which needs a "
                                 "card; cpu runs the plain PyTorch path)")

    pt = sub.add_parser("train")
    pt.add_argument("--preset", default="kitti", choices=list(PRESETS))
    pt.add_argument("--data_path", required=True)
    pt.add_argument("--set", nargs="*", help="config overrides key=value")
    pt.add_argument("--seg_pkl", default=None,
                    help="detectron2 .pkl Mask2Former weights (required for "
                         "--set temporal=true/main_temporal=true/"
                         "online_doj=true)")
    pt.add_argument("--load_pretrained", default=None,
                    help="reference-layout .pth checkpoint dir to initialize "
                         "from (--load_pretrained/--load_weights_folder)")
    pt.add_argument("--imagenet_ckpt", default=None,
                    help="torchvision ImageNet resnet18 .pth for trunk init "
                         "(--weights_init pretrained)")
    pt.add_argument("--mono_ckpt", default=None,
                    help="checkpoint dir for teacher+pose nets only "
                         "(--mono_weights_folder)")
    pt.add_argument("--models_to_load", nargs="*", default=None,
                    help="subset of sub-nets to take from --load_pretrained")
    pt.add_argument("--resume", default=None,
                    help="the port's checkpoint to resume mid-run")
    pt.add_argument("--gt", default=None,
                    help="gt depths for validation metrics (gt_depths.npz "
                         "or a dir of NNN_depth.npy)")
    pt.add_argument("--eval_data_path", default=None,
                    help="data root for the validation split when it "
                         "differs from --data_path (the reference's "
                         "--cs_eval_path, `manydepth/trainer.py:296`)")
    pt.add_argument("--no_eval", action="store_true",
                    help="skip building the validation loader (checkpoints "
                         "are written at validation, so none are)")
    pt.add_argument("--coordinator", default=None,
                    help="host:port of rank 0 for data-parallel training, "
                         "one process per card (NCCL; gloo with --device "
                         "cpu)")
    pt.add_argument("--num_hosts", type=int, default=1,
                    help="processes in a data-parallel run (in the port, "
                         "processes: one per card)")
    pt.add_argument("--host_id", type=int, default=0,
                    help="this process's rank in a data-parallel run; it "
                         "uses cuda:{rank %% device_count}")
    device_flag(pt)
    pt.set_defaults(fn=cmd_train)

    pe = sub.add_parser("eval")
    pe.add_argument("--preset", default="kitti", choices=list(PRESETS))
    pe.add_argument("--data_path", required=True)
    pe.add_argument("--ckpt", default=None,
                    help="the port's checkpoint (step_* dir or its parent) or "
                         "a reference .pth dir; optional with "
                         "--ext_disp_to_eval")
    pe.add_argument("--gt", default=None,
                    help="gt_depths.npz (optional with --no_eval or "
                         "eval_split=benchmark)")
    pe.add_argument("--doj_root", default=None,
                    help="dynamic-object mask dir (method=dynamicdepth)")
    pe.add_argument("--eval_teacher", action="store_true",
                    help="evaluate the mono teacher instead of the student")
    pe.add_argument("--post_process", action="store_true",
                    help="Monodepth-v1 flip averaging (teacher only)")
    pe.add_argument("--zero_cost_volume", action="store_true",
                    help="behavioral probe: zero lookup poses")
    pe.add_argument("--static_camera", action="store_true",
                    help="behavioral probe: lookup frames = current frame")
    pe.add_argument("--save_pred_disps", action="store_true",
                    help="save the predicted disparity stack next to the "
                         "checkpoint")
    pe.add_argument("--ext_disp_to_eval", default=None,
                    help="evaluate a saved .npy disparity stack instead of "
                         "running inference")
    pe.add_argument("--no_eval", action="store_true",
                    help="skip metric computation (with --save_pred_disps)")
    pe.add_argument("--disable_median_scaling", action="store_true")
    pe.add_argument("--pred_depth_scale_factor", type=float, default=1.0)
    pe.add_argument("--eval_stereo", action="store_true",
                    help="stereo-trained model: scale 5.4, no median "
                         "scaling")
    pe.add_argument("--set", nargs="*")
    device_flag(pe)
    pe.set_defaults(fn=cmd_eval)

    pp = sub.add_parser("export-pth")
    pp.add_argument("--ckpt", required=True,
                    help="the port's checkpoint (step_* dir or its parent)")
    pp.add_argument("--out", required=True,
                    help="output dir for the reference-layout .pth files")
    pp.add_argument("--set", nargs="*")
    device_flag(pp)
    pp.set_defaults(fn=cmd_export_pth)

    pf = sub.add_parser("finetune-seg", help="fine-tune the Mask2Former "
                        "segmenter on a COCO-format dataset")
    pf.add_argument("--images", required=True, help="image directory")
    pf.add_argument("--annotations", required=True, help="COCO json")
    pf.add_argument("--out", default=None,
                    help="output dir for model.pkl and seg_state.pt")
    pf.add_argument("--seg_pkl", default=None,
                    help="initialize from detectron2 .pkl weights")
    pf.add_argument("--size", default="tiny",
                    choices=("tiny", "small", "base", "large"))
    pf.add_argument("--height", type=int, default=256)
    pf.add_argument("--width", type=int, default=448)
    pf.add_argument("--epochs", type=int, default=1)
    pf.add_argument("--batch_size", type=int, default=2)
    pf.add_argument("--lr", type=float, default=1e-4)
    pf.add_argument("--weight_decay", type=float, default=0.05)
    pf.add_argument("--num_queries", type=int, default=100)
    pf.add_argument("--max_instances", type=int, default=16)
    pf.add_argument("--num_points", type=int, default=112 * 112)
    pf.add_argument("--seed", type=int, default=0)
    device_flag(pf)
    pf.set_defaults(fn=cmd_finetune_seg)
    px = sub.add_parser(
        "export-seg", help="precompute the temporal hint's current-frame "
        "instances for the training split (train with --set "
        "seg_cache_root=...)")
    px.add_argument("--preset", default="kitti", choices=list(PRESETS))
    px.add_argument("--data_path", required=True)
    px.add_argument("--seg_pkl", required=True,
                    help="detectron2 .pkl Mask2Former weights (the same "
                         "checkpoint the temporal hint trains with)")
    px.add_argument("--out", required=True,
                    help="cache directory (pass as --set seg_cache_root=... "
                         "on train)")
    px.add_argument("--size", default="large",
                    choices=("tiny", "small", "base", "large"),
                    help="Swin size of the .pkl checkpoint")
    px.add_argument("--set", nargs="*",
                    help="config overrides key=value; the precision is the "
                         "preset's, exact fp32 by default (unlike train, "
                         "whose default is the bf16 fast mode): pass "
                         "compute_dtype='bfloat16' to export with the fast "
                         "segmenter")
    device_flag(px)
    px.set_defaults(fn=cmd_export_seg)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main(sys.argv[1:])
