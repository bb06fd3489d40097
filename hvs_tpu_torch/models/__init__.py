"""Models of the port: the flagship with its detection, segmentation, depth
and classification heads and its retrieval module (``rag.py``), the
lightweight variant, their layers, the off-path pieces of the JAX package
(RMSNorm, manifold attention, patch embedding, the ViT decoder, the FPN
fusion variants, the stability summary) and the int8 calibration of the
serve model, under the public names of ``hvs_tpu/models``."""

from .backbone import ConvMHCBlock, HybridVisionBackbone
from .constraints import compute_constraints, load_constraints, param_tree
from .fpn import (AdaptiveFeatureFusion, CrossScaleAttention, FeaturePyramidNetwork,
                  MultiScaleFeatureFusion, upsample2x)
from .hybrid import (DepthHead, HybridVisionSystem, LightweightHybridVision,
                     ProductionHybridVision, SegmentationHead, collect_stability_metrics, detect)
from .layers import (DenseAttention, ManifoldHyperConnection, MHCTransformerBlock,
                     MultiHeadManifoldAttention, RMSNorm, SqueezeExcite)
from .quantize import calibrate_quant_scales, load_quant_scales
from .rag import KnowledgeAwareDetection, RAGVisionKnowledge, build_knowledge_base, \
    roi_pool_bilinear
from .vit import (HybridVisionEncoder, PatchEmbedding, VisionTransformerDecoder,
                  VisionTransformerEncoder, interpolate_pos_embed)
from .yolo_head import (ANCHOR_REF_GRIDS, COCO_ANCHORS_416, YOLODetectionHead,
                        YOLOPredictionHead, decode_predictions, effective_anchors,
                        make_anchor_grid, postprocess_detections)

__all__ = [
    "compute_constraints", "load_constraints", "param_tree", "calibrate_quant_scales",
    "load_quant_scales", "RMSNorm", "ManifoldHyperConnection", "SqueezeExcite",
    "MultiHeadManifoldAttention", "DenseAttention", "MHCTransformerBlock", "ConvMHCBlock",
    "HybridVisionBackbone", "PatchEmbedding", "interpolate_pos_embed",
    "VisionTransformerEncoder", "VisionTransformerDecoder", "HybridVisionEncoder",
    "FeaturePyramidNetwork", "MultiScaleFeatureFusion", "CrossScaleAttention",
    "AdaptiveFeatureFusion", "upsample2x", "ANCHOR_REF_GRIDS", "COCO_ANCHORS_416",
    "effective_anchors", "make_anchor_grid", "YOLOPredictionHead", "decode_predictions",
    "YOLODetectionHead", "postprocess_detections", "build_knowledge_base",
    "RAGVisionKnowledge", "KnowledgeAwareDetection", "roi_pool_bilinear", "SegmentationHead",
    "DepthHead", "HybridVisionSystem", "LightweightHybridVision", "ProductionHybridVision",
    "detect", "collect_stability_metrics",
]
