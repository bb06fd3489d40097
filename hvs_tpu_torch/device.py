"""Device resolution for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU with
``device="cpu"``. There is no silent CPU path: with no CUDA device and no
explicit CPU request, they raise.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]
_CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` (the current card) when ``device`` is None; otherwise the
    device asked for. Raises if that is a CUDA device and none is present."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def pin_matmul_precision() -> None:
    """Turn off TF32 in cuBLAS and cuDNN and reduced-precision bf16 GEMM
    reductions, so matmuls and convolutions accumulate in fp32 as the JAX
    reference does (its kernels accumulate in fp32, its tests pin fp32
    matmuls).

    The three flags are process-wide: calling this from one entry point
    changes them for every model and tensor in the process. Every entry point
    of the port (``Detector``, ``InferenceEngine``,
    ``ManifoldConstrainedTrainer``, ``python -m hvs_tpu_torch.train``) calls it.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def device_constant(key: Tuple, device: torch.device, make: Callable[[], Sequence]
                    ) -> torch.Tensor:
    """An fp32 tensor of the numbers ``make()`` returns, kept on ``device``
    under ``key``: copied from the host once, so later calls copy nothing
    (a CUDA graph capture does not allow such a copy)."""
    full = key + (str(device),)
    t = _CONSTANTS.get(full)
    if t is None:
        t = torch.tensor(make(), dtype=torch.float32).to(device)
        _CONSTANTS[full] = t
    return t
