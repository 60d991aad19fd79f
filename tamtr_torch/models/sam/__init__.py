"""Segment Anything in torch (a port of the JAX package's
`tamtr_tpu/models/sam/`): promptable segmentation (points, boxes, masks)
and automatic "segment everything" generation, with the ViT-B/L/H and
MobileSAM (TinyViT) image encoders."""

from tamtr_torch.models.sam.build import (
    SamModel, build_mobile_sam, build_sam, build_sam_tiny_test, build_sam_vit_b, build_sam_vit_h, build_sam_vit_l,
)
from tamtr_torch.models.sam.predict import SAMPredictor

__all__ = ["SamModel", "SAMPredictor", "build_sam", "build_sam_vit_b", "build_sam_vit_l", "build_sam_vit_h",
           "build_mobile_sam", "build_sam_tiny_test"]
