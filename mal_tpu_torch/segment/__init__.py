"""The Mask2Former segmenter (frozen for the MAL temporal hint, trainable
for `finetune-seg`), its criterion, datasets and inference, the
MaskFormer-v1 family, and the instance matcher of the hint (PyTorch)."""

from mal_tpu_torch.segment.criterion import (CriterionConfig,  # noqa: F401
                                             set_criterion, set_criterion_deep)
from mal_tpu_torch.segment.datasets import (CATALOGS, SegCatalog,  # noqa: F401
                                            SemSegFolderDataset,
                                            catalog_from_panoptic_json,
                                            panoptic_to_targets,
                                            semantic_to_targets)
from mal_tpu_torch.segment.inference import (PanopticSeg,  # noqa: F401
                                             panoptic_inference,
                                             semantic_inference, semantic_tta)
from mal_tpu_torch.segment.instances import Instances  # noqa: F401
from mal_tpu_torch.segment.maskformer_v1 import (  # noqa: F401
    FPNPixelDecoder, MaskFormerV1, PerPixelBaselineHead,
    StandardTransformerDecoder, TransformerEncoderPixelDecoder)
from mal_tpu_torch.segment.matcher import (hungarian_match,  # noqa: F401
                                           match_instances)
