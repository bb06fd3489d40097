"""Ops: Sinkhorn, box geometry, fixed-shape NMS and the fused mHC block."""
