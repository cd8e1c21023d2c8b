"""Mask2Former, its instance inference and its fine-tuning loss (PyTorch).

Counterpart of `mal_tpu.segment.mask2former` (reference
`mask2former/maskformer_model.py:21-380`): the frozen instance segmenter of
the MAL temporal hint (`manydepth/trainer.py:350-357`), and in train mode
the model `finetune-seg` trains (`mask2former_train_loss`). The module tree
has detectron2's names (`backbone`, `sem_seg_head.pixel_decoder`,
`sem_seg_head.predictor`), so its state dict has the keys of the published
checkpoints.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from mal_tpu_torch.device import resolve_device
from mal_tpu_torch.ops.cuda.deform_sample import ms_deform_attn_core
from mal_tpu_torch.ops.cuda.swin_block import swin_attn_fused, swin_mlp_fused
from mal_tpu_torch.ops.cuda.window_attention import window_attention
from mal_tpu_torch.ops.interp import resize_bilinear
from mal_tpu_torch.segment.criterion import (CriterionConfig,
                                             set_criterion_deep, weight_dict,
                                             weighted_total)
from mal_tpu_torch.segment.instances import Instances
from mal_tpu_torch.segment.msdeform import MSDeformAttn
from mal_tpu_torch.segment.pixel_decoder import MSDeformAttnPixelDecoder
from mal_tpu_torch.segment.swin import CONFIGS, SwinTransformer, WindowAttention
from mal_tpu_torch.segment.transformer_decoder import (MaskedTransformerDecoder,
                                                       MultiheadAttention)
from mal_tpu_torch.utils import profiling

Tensor = torch.Tensor

# detectron2 COCO normalisation (cfg MODEL.PIXEL_MEAN / PIXEL_STD), applied
# to [0, 255] inputs
_PIXEL_MEAN = (123.675, 116.28, 103.53)
_PIXEL_STD = (58.395, 57.12, 57.375)


def register_pixel_stats(model: nn.Module) -> None:
    """Give `model` the normalisation's mean and std as non-persistent
    buffers `pixel_mean` and `pixel_std` (not in the state dict, so the
    checkpoints' keys are unchanged): made once on the host, they move with
    the model, and a forward copies nothing from the host."""
    model.register_buffer("pixel_mean", torch.tensor(_PIXEL_MEAN),
                          persistent=False)
    model.register_buffer("pixel_std", torch.tensor(_PIXEL_STD),
                          persistent=False)


def preprocess_images(images: Tensor, bgr_input: bool = True, *,
                      mean: Tensor, std: Tensor) -> Tensor:
    """The reference's segmenter preprocessing of (B, H, W, 3) RGB frames in
    [0, 1]: it feeds Mask2Former **BGR** frames (`manydepth/dyn_utils.py:
    176-178`) that detectron2 then normalises with RGB-ordered means
    (`maskformer_model.py:193-195`). The mismatch is the released models'
    behaviour and is kept by default; `bgr_input=False` is the
    colour-correct form fine-tuning uses (`mal_tpu/cli.py:436-437`).
    `mean` and `std`: a model's `pixel_mean` and `pixel_std`
    (`register_pixel_stats`), on the frames' device. The frames are made
    contiguous first, so that the model's output does not depend on the
    layout the caller's frames have (a permuted view of NCHW frames would
    carry its layout into the patch embedding, whose convolution then takes
    another algorithm)."""
    images = images.contiguous()
    if bgr_input:
        images = images.flip(-1)
    return (images * 255.0 - mean) / std


def resolve_fused_swin(cfg, device: str | torch.device | None = None) -> bool:
    """`Config.seg_fused_swin` for the frozen segmenter, None meaning auto:
    on when the segmenter runs on a CUDA device in fast mode
    (`compute_dtype="bfloat16"`), the port's reading of
    `mal_tpu/segment/mask2former.py:47-61` (there: on the TPU and in bf16).
    In exact fp32 mode and on the CPU auto means off."""
    if cfg.seg_fused_swin is not None:
        return cfg.seg_fused_swin
    return (resolve_device(device).type == "cuda"
            and cfg.compute_dtype == "bfloat16")


def _lecun_normal_(w: Tensor, fan_in: int, generator: torch.Generator):
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initialisers as `mal_tpu`'s segmenter uses them: Dense and
    Conv kernels lecun-normal, biases 0, norms 1 / 0; the relative-position
    tables truncated normal with stddev 0.02; the level and query
    embeddings standard normal; the deformable attention's offset and
    weight kernels 0 (`msdeform.py:157-161`)."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, MultiheadAttention):
            C = m.in_proj_weight.shape[1]
            for w in m.in_proj_weight.chunk(3):
                _lecun_normal_(w, C, generator)
            nn.init.zeros_(m.in_proj_bias)
        elif isinstance(m, nn.Embedding):
            nn.init.normal_(m.weight, generator=generator)
        elif isinstance(m, WindowAttention):
            nn.init.trunc_normal_(m.relative_position_bias_table, 0.0, 0.02,
                                  -0.04, 0.04, generator=generator)
    for m in model.modules():
        if isinstance(m, MSDeformAttn):
            nn.init.zeros_(m.sampling_offsets.weight)
            nn.init.zeros_(m.attention_weights.weight)
    level_embed = getattr(model.sem_seg_head.pixel_decoder.transformer,
                          "level_embed", None)    # none in MaskFormer v1
    if level_embed is not None:
        nn.init.normal_(level_embed, generator=generator)


class Mask2Former(nn.Module):
    """The segmenter on `device` (default: the GPU, raising if there is
    none), with flax-style random weights from `generator` (default: seed
    0), drawn on the CPU and then moved; `load_jax_mask2former` or a
    detectron2 state dict replaces them (`init_weights=False` skips the
    draw, seconds on the CPU, for a model loaded next).

    `bf16_backbone` (fast mode) runs the Swin blocks' and the pixel
    decoder's FFN Linears in bf16; `fused_swin` runs every Swin block as
    kernels K2 and K3 (`resolve_fused_swin` says when a configuration asks
    for it). Neither changes the parameters or the state-dict keys.
    `bgr_input` as `preprocess_images`; `drop_path_rate` is the Swin's
    stochastic depth in train mode (`mask2former/config.py:86`).

    The model is built frozen (no parameter requires a gradient), as the
    temporal hint uses it; `requires_grad_(True)` makes it trainable for
    `mask2former_train_loss`. The forward's `train` argument alone picks
    the route: no module here reads `self.training`."""

    def __init__(self, num_classes: int = 80, swin_size: str = "large",
                 num_queries: int = 100,
                 device: str | torch.device | None = None,
                 generator: torch.Generator | None = None,
                 bf16_backbone: bool = False, fused_swin: bool = False,
                 init_weights: bool = True, bgr_input: bool = True,
                 drop_path_rate: float = 0.3):
        super().__init__()
        device = resolve_device(device)
        self.swin_size = swin_size
        self.num_classes = num_classes
        self.bgr_input = bgr_input
        embed = CONFIGS[swin_size][0]
        self.backbone = SwinTransformer(swin_size, bf16_compute=bf16_backbone,
                                        fused_block=fused_swin,
                                        drop_path_rate=drop_path_rate)
        self.sem_seg_head = nn.Module()
        self.sem_seg_head.pixel_decoder = MSDeformAttnPixelDecoder(
            {f"res{s + 2}": embed * 2 ** s for s in range(4)},
            bf16_compute=bf16_backbone)
        self.sem_seg_head.predictor = MaskedTransformerDecoder(
            num_classes=num_classes, num_queries=num_queries)
        if init_weights:
            with torch.no_grad():
                init_like_flax(self, generator
                               or torch.Generator().manual_seed(0))
        register_pixel_stats(self)
        self.eval()
        self.requires_grad_(False)   # frozen
        self.to(device)

    def forward(self, images: Tensor, return_aux: bool = False,
                train: bool = False,
                generator: torch.Generator | None = None
                ) -> tuple[Tensor, Tensor]:
        """images (B, H, W, 3) in [0, 1] RGB. Returns (pred_logits (B, Q,
        K+1), pred_masks (B, Q, H/4, W/4)); with `return_aux` every decoder
        layer's, stacked (`MaskedTransformerDecoder`). `train=True` is the
        training forward: the kernels' plain versions, through which
        autograd runs, and Swin drop-path with keep-masks from `generator`;
        `train=False` launches kernels K4 and K5 on CUDA tensors (K2 and K3
        with `fused_swin`), which take no gradient."""
        feats = self.backbone(preprocess_images(images, self.bgr_input,
                                                mean=self.pixel_mean,
                                                std=self.pixel_std),
                              train, generator)
        mask_features, multi_scale = self.sem_seg_head.pixel_decoder(feats,
                                                                     train)
        return self.sem_seg_head.predictor(multi_scale, mask_features,
                                           return_aux)


def instance_inference(pred_logits: Tensor, pred_masks: Tensor, out_h: int,
                       out_w: int, max_instances: int) -> Instances:
    """Top-k padded instances (`maskformer_model.py:344-380`): class-softmax
    scores without the background, a fixed top-`max_instances` over
    (queries x classes), mask logits upsampled and thresholded at 0, and
    the score times the mean in-mask probability."""
    return instances_from_top(
        *top_queries(pred_logits, pred_masks, max_instances), out_h, out_w)


def top_queries(pred_logits: Tensor, pred_masks: Tensor, max_instances: int
                ) -> tuple[Tensor, Tensor, Tensor]:
    """`instance_inference`'s choice: the top-`max_instances` (query,
    class) pairs by class-softmax score without the background. Returns
    their (B, N) scores and classes and their queries' mask logits (B, N,
    H/4, W/4)."""
    B, Q, K1 = pred_logits.shape
    K = K1 - 1
    scores = pred_logits.softmax(dim=-1)[..., :K].reshape(B, Q * K)
    top_scores, top_idx = scores.topk(max_instances, dim=1)
    top_q = top_idx // K
    top_class = top_idx % K
    h, w = pred_masks.shape[-2:]
    masks = pred_masks.gather(1, top_q[:, :, None, None].expand(-1, -1, h, w))
    return top_scores, top_class, masks


def instances_from_top(top_scores: Tensor, top_class: Tensor, masks: Tensor,
                       out_h: int, out_w: int) -> Instances:
    """The rest of `instance_inference` on `top_queries`' choice: the mask
    logits upsampled and thresholded at 0, the scores times the mean
    in-mask probability."""
    masks_up = resize_bilinear(masks, out_h, out_w)
    binary = (masks_up > 0.0).to(torch.float32)
    prob = masks_up.sigmoid()
    mask_score = ((prob * binary).sum(dim=(2, 3))
                  / (binary.sum(dim=(2, 3)) + 1e-6))
    final = top_scores * mask_score
    return Instances(masks=binary, classes=top_class.to(torch.int32),
                     scores=final, valid=torch.ones_like(final, dtype=torch.bool))


def mask2former_train_loss(model: Mask2Former, images: Tensor,
                           tgt_labels: Tensor, tgt_masks: Tensor,
                           tgt_valid: Tensor,
                           criterion_cfg: CriterionConfig | None = None,
                           generator: torch.Generator | None = None,
                           draws: list[dict] | None = None,
                           timings: dict | None = None
                           ) -> tuple[Tensor, dict]:
    """The fine-tuning objective (`mal_tpu/segment/mask2former.py:140-162`,
    the training path of `maskformer_model.py:198-216`): the training
    forward with deep supervision, the Hungarian set losses of every layer
    and their weighted sum. Returns (total, per-term dict).

    images (B, H, W, 3) in [0, 1]; targets padded to a static T with
    `tgt_valid` (`segment/criterion.py`). `generator` draws the drop-path
    keep-masks and the criterion's points; `draws` injects the points
    (`criterion.draw_points`); `timings` as `set_criterion_deep`."""
    cfg = criterion_cfg or CriterionConfig(num_classes=model.num_classes)
    logits, masks = model(images, return_aux=True, train=True,
                          generator=generator)
    losses = set_criterion_deep(logits, masks, tgt_labels, tgt_masks,
                                tgt_valid, cfg, generator=generator,
                                draws=draws, timings=timings)
    total = weighted_total(losses, weight_dict(cfg, logits.shape[0] - 1))
    return total, losses


class _SegmenterGraph:
    """`fn(images)` at one input shape and dtype, captured once as a CUDA
    graph: `graph(images)` copies the images into the static input,
    replays, and returns the static outputs, which the next replay
    overwrites. The kernel wrappers' `.launches` gain at each replay what
    the capture counted, so they count the launches the device ran."""

    def __init__(self, fn, images: Tensor):
        self.input = torch.empty(images.shape, dtype=images.dtype,
                                 device=images.device)
        before = [f.launches for f in _COUNTED]
        self.graph = torch.cuda.CUDAGraph()
        try:
            # thread-local: a loader thread's copies do not break the capture
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.outputs = fn(self.input)
            self.launches = [f.launches - n for f, n in zip(_COUNTED, before)]
        finally:
            for f, n in zip(_COUNTED, before):
                f.launches = n   # the capture launched nothing
        profiling.count("seg_graph_captures")

    def __call__(self, images: Tensor) -> tuple:
        self.input.copy_(images)
        self.graph.replay()
        for f, n in zip(_COUNTED, self.launches):
            f.launches += n
        profiling.count("seg_graph_replays")
        return self.outputs


# the kernel wrappers an inference forward may launch, whose `.launches`
# count their launches
_COUNTED = (swin_attn_fused, swin_mlp_fused, window_attention,
            ms_deform_attn_core)


def make_seg_fn(model: Mask2Former, max_instances: int):
    """`seg_fn(images (B, H, W, 3)) -> Instances`, the temporal hint's
    segmenter: the frozen model under `torch.no_grad()` on detached frames
    (the reference runs Mask2Former under no_grad, `dyn_utils.py:185-186`),
    then `instance_inference`.

    On a CUDA device the forward and `instance_inference`'s choice of
    queries (`top_queries`) are replayed as a CUDA graph, one for each
    input (shape, dtype): the first call of a shape runs eagerly (the
    warm-up, which forward hooks see), the second captures and replays,
    every later one copies the images into the graph's static input and
    replays. A shape seen once is never captured. The upsampling of the
    chosen masks (`instances_from_top`) runs eagerly on the graph's
    outputs, and what it returns shares no memory with them. The graph
    keeps its static input and outputs allocated while `seg_fn` lives (at
    batch 12, 192x640 and 16 instances: 17.7 MB of input, 5.9 MB of
    masks; with cuBLAS's workspace for the capture's stream, 57.7 MB on an
    H100), and its private pool holds the memory of a forward's
    intermediates (reserved, not allocated, between replays). It reads
    the weights where they are: a weight loaded in place
    (`load_state_dict`, `copy_`) is seen by the next replay, a parameter
    replaced by another tensor is not. Hooks attached after the capture do
    not run at a replay. `Mask2Former.forward` itself stays eager; on the
    CPU so does every call."""
    graphs: dict = {}   # (shape, dtype) -> None once seen, then its graph

    def top(images: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        return top_queries(*model(images), max_instances)

    def forward(images: Tensor) -> tuple[Tensor, Tensor, Tensor]:
        if images.device.type != "cuda":
            return top(images)
        key = (tuple(images.shape), images.dtype)
        if key not in graphs:
            graphs[key] = None
            return top(images)
        if graphs[key] is None:
            graphs[key] = _SegmenterGraph(top, images)
        return graphs[key](images)

    def seg_fn(images: Tensor) -> Instances:
        H, W = images.shape[1:3]
        with profiling.span("mal.segmenter"), torch.no_grad():
            return instances_from_top(*forward(images.detach()), H, W)

    return seg_fn
