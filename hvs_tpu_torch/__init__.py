"""HumanoidVision in PyTorch for NVIDIA Hopper: the port of ``hvs_tpu``.

The JAX package ``hvs_tpu`` is the reference. This package keeps its module
layout and names, runs on a CUDA card unless a caller passes ``device="cpu"``,
and replaces each of its Pallas TPU kernels by a CUDA kernel written for
Hopper (``csrc/``, built with nvcc at first use). It imports neither JAX nor
anything of ``hvs_tpu``.
"""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
