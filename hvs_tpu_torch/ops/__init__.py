"""Ops: Sinkhorn and the manifold toolbox, box geometry, fixed-shape NMS and
int8 quantization, under the public names of ``hvs_tpu/ops``. The fused mHC
block's wrappers stay in the submodule ``ops.mhc_block`` (a name here would
hide the module)."""

from .boxes import (box_area, box_ciou, box_giou, box_iou, clip_boxes, cxcywh_to_xyxy,
                    pairwise_iou, xyxy_to_cxcywh)
from .manifold import (birkhoff_project, birkhoff_tangent_project, check_manifold_constraints,
                       manifold_regularization, riemannian_gradient, spd_distance,
                       spd_project, spd_retract_expm, stiefel_distance, stiefel_project,
                       stiefel_retract_cayley, stiefel_tangent_project)
from .nms import NMSResult, batched_nms, matrix_nms, nms_fixed, soft_nms_fixed
from .quant import (build_quant_collection, calib_maxabs, conv_int8, dequantize_tensor,
                    matmul_int8, merge_max_stats, merge_percentile_stats, quantization_error,
                    quantize_tensor, quantize_weight_per_channel)
from .sinkhorn import (doubly_stochastic_error, project_to_doubly_stochastic, sinkhorn_knopp,
                       sinkhorn_log, sinkhorn_log_many, sinkhorn_regularization_loss,
                       sinkhorn_with_diagnostics)

__all__ = [
    "sinkhorn_log", "sinkhorn_log_many", "sinkhorn_knopp", "project_to_doubly_stochastic",
    "doubly_stochastic_error", "sinkhorn_regularization_loss", "sinkhorn_with_diagnostics",
    "birkhoff_project", "birkhoff_tangent_project", "stiefel_project",
    "stiefel_tangent_project", "stiefel_retract_cayley", "stiefel_distance", "spd_project",
    "spd_retract_expm", "spd_distance", "riemannian_gradient", "manifold_regularization",
    "check_manifold_constraints", "cxcywh_to_xyxy", "xyxy_to_cxcywh", "box_area", "box_iou",
    "pairwise_iou", "box_giou", "box_ciou", "clip_boxes", "NMSResult", "nms_fixed",
    "soft_nms_fixed", "matrix_nms", "batched_nms", "calib_maxabs", "quantize_tensor",
    "dequantize_tensor", "quantize_weight_per_channel", "conv_int8", "matmul_int8",
    "quantization_error", "build_quant_collection", "merge_max_stats",
    "merge_percentile_stats",
]
