"""The reference's DynamicDepth configuration: the ManyDepth reference's
`Config` (`gpubench/reference/config.py`) with the fields of the port's
`Config` (`mal_tpu_torch/config.py`) that the copied DynamicDepth step
reads, at the port's defaults (`dynamicdepth/options.py:298-339`)."""

from __future__ import annotations

from dataclasses import dataclass

from gpubench.reference import config


@dataclass(frozen=True)
class Config(config.Config):
    method: str = "dynamicdepth"
    # the occlusion-aware cost volume (`resnet_encoder.py:148-249`)
    cv_min: bool = False
    cv_set_1: bool = False
    cv_pool: bool = False
    cv_pool_radius: int = 1
    cv_pool_th: float = 0.7
    # the DOMD warp (`trainer.py:492-537`)
    no_warp: bool = False
    no_reproj_doj: bool = False
    # the loss merge (`trainer.py:630-650`)
    tempv2: bool = False
    no_multi_loss: bool = False
    # `--no_teacher_warp` is store_false upstream, so True by default
    no_teacher_warp: bool = True
    # the reprojection variants (`trainer.py:955-966,1058-1065`)
    selec_reproj: bool = False
    zero_img: bool = False
