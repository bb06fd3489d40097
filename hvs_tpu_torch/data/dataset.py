"""Letterboxing: aspect-preserving bilinear resize and centred pad.

Counterpart of ``hvs_tpu/data/dataset.py::letterbox`` and of the raw-frame
preprocessing inside ``hvs_tpu/inference/engine.py``'s serve program. The
geometry is the reference's: scale = S / max(h, w), the resized size rounded,
the padding centred (floor of half the slack on the left and top). Both
resize in torch (bilinear, half-pixel centres, no antialias) on the device
the image is on; cv2 is not needed.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Image = Union[np.ndarray, torch.Tensor]


def letterbox_geometry(h: int, w: int, size: int) -> Tuple[float, Tuple[int, int],
                                                              Tuple[int, int]]:
    """(scale, (new_h, new_w), (pad_x, pad_y)) of an h x w image boxed into
    size x size."""
    scale = size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return scale, (nh, nw), ((size - nw) // 2, (size - nh) // 2)


def _resize_nhwc(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of float NHWC maps, half-pixel centres, no antialias:
    ``jax.image.resize(..., "bilinear", antialias=False)`` and cv2's
    INTER_LINEAR sample the same points."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=hw, mode="bilinear", align_corners=False,
                      antialias=False)
    return y.permute(0, 2, 3, 1)


def letterbox(image: Image, size: int, pad_value: int = 114
              ) -> Tuple[Image, float, Tuple[int, int]]:
    """Resize ``image`` [h, w, c] to fit ``size`` x ``size`` and pad it with
    ``pad_value``; returns (padded, scale, (pad_x, pad_y)).

    A numpy image comes back as numpy (computed on the CPU), a tensor as a
    tensor on its own device. uint8 images are resized in fp32 and rounded half up
    to uint8, as the reference's host letterbox rounds after its resize; the
    two agree within one grey level (cv2 and the native letterbox interpolate
    in fixed point or another summation order).
    """
    as_numpy = isinstance(image, np.ndarray)
    x = torch.from_numpy(np.ascontiguousarray(image)) if as_numpy else image
    h, w, c = x.shape
    scale, (nh, nw), (pad_x, pad_y) = letterbox_geometry(h, w, size)
    resized = x
    if (nh, nw) != (h, w):
        resized = _resize_nhwc(x[None].float(), (nh, nw))[0]
        if x.dtype == torch.uint8:
            resized = torch.floor(resized + 0.5).clamp_(0, 255)
        resized = resized.to(x.dtype)
    out = torch.full((size, size, c), pad_value, dtype=x.dtype, device=x.device)
    out[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    if as_numpy:
        out = out.cpu().numpy()
    return out, scale, (pad_x, pad_y)


def letterbox_raw_batch(images_u8: torch.Tensor, size: int, pad_value: int = 114,
                        bgr_to_rgb: bool = True) -> torch.Tensor:
    """The raw-frame preprocessing of the engine's serve graphs: uint8
    [B, h, w, 3] frames -> fp32 [B, size, size, 3] in [0, 1], letterboxed.

    As the reference's raw program (``hvs_tpu/inference/engine.py:483-503``):
    BGR -> RGB, divide by 255, bilinear resize (no antialias) when the size
    changes, then a canvas of ``pad_value / 255`` with the frame at the
    centred offset. Nothing is rounded to uint8 on this path.
    """
    x = images_u8
    if bgr_to_rgb:
        x = x.flip(-1)
    x = x.float() / 255.0
    b, h, w, _ = x.shape
    _, (nh, nw), (pad_x, pad_y) = letterbox_geometry(h, w, size)
    if (nh, nw) != (h, w):
        x = _resize_nhwc(x, (nh, nw))
    if (nh, nw) != (size, size):
        canvas = torch.full((b, size, size, 3), pad_value / 255.0, dtype=torch.float32,
                            device=x.device)
        canvas[:, pad_y:pad_y + nh, pad_x:pad_x + nw] = x
        x = canvas
    return x
