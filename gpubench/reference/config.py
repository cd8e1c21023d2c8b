"""The reference's configuration: the fields of the port's `Config`
(`mal_tpu_torch/config.py`) that the copied ManyDepth + MAL step reads, with
the port's defaults, which mirror the reference training recipe: batch 12,
lr 1e-4, 96 depth bins, 192x640, frames {0,-1,+1}, smoothness 1e-3
(`manydepth/options.py:50-109`). A configuration file's `port_config`
sets some of them; a key this copy lacks is refused by the dataclass.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Config:
    # --- model ---
    num_layers: int = 18
    height: int = 192
    width: int = 640
    num_depth_bins: int = 96
    depth_binning: str = "linear"  # linear | inverse | log
    min_depth: float = 0.1
    max_depth: float = 100.0

    # --- frames ---
    # frame offsets used for the photometric loss; first must be 0.
    frame_ids: tuple[int, ...] = (0, -1, 1)
    num_matching_frames: int = 1
    use_future_frame: bool = False

    # --- training ---
    batch_size: int = 12
    learning_rate: float = 1e-4
    disparity_smoothness: float = 1e-3
    # the reference's WarmupStepLRScheduler (`manydepth/trainer.py:194-232`)
    warmup_steps: int = 500
    decay_steps: int = 48000
    init_lr: float = 1e-10
    # matching augmentation probabilities (static-camera / zero-cost-volume)
    # (`manydepth/networks/repdepth.py:279-293`)
    aug_static_camera_p: float = 0.25
    aug_zero_cost_volume_p: float = 0.25
    grad_clip_norm: float = 0.0   # optional global-norm clip (0 = off)
    disable_automasking: bool = False
    disable_motion_masking: bool = False
    no_matching_augmentation: bool = False
    freeze_teacher_and_pose: bool = False
    freeze_pose: bool = False
    no_ssim: bool = False         # --no_ssim: pure-L1 photometric loss
    # --avg_reprojection: per-pixel mean over source frames instead of the
    # min, with monodepth2's semantics
    avg_reprojection: bool = False

    # --- MAL hints ---
    distil: bool = True           # distillation hint
    use_ensemble: bool = True     # 3-way {mono, ensemble, multi} distillation
    dual_distil: bool = False     # distil toward non-detached mono depth
    loss_blc: bool = True         # automatic two-term loss re-balancing
    temporal: bool = False        # temporal hint (dynamic-object synthesis)
    main_temporal: bool = False
    ins_threshold: float = 0.9    # instance score threshold of the temporal
                                  # hint (`manydepth/options.py:299-302`)
    max_instances: int = 16       # static-shape cap on instances per image
    # loss-balancing lambda schedule (`manydepth/options.py:443-445`)
    lambda_for_adjust_start: float = 3.0
    lambda_for_adjust_slope: float = -1.5
    lambda_for_adjust_min: float = -3.0

    # --- depth-bin tracker ---
    adaptive_bins: bool = True
    depth_bin_ema: float = 0.99

    # --- precision ---
    compute_dtype: str = "float32"   # float32 | bfloat16
    # the port's choice of K1's precision; its plain version here is exact
    # in both, so this copy reads it nowhere
    cv_mxu_precision: str = "highest"

    @property
    def matching_ids(self) -> tuple[int, ...]:
        out = [0]
        if self.use_future_frame:
            out.append(1)
        for idx in range(-1, -1 - self.num_matching_frames, -1):
            out.append(idx)
        return tuple(out)
