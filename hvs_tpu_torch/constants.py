"""Shared constants: the default image normalization.

Counterpart of ``IMAGENET_MEAN`` and ``IMAGENET_STD`` in ``hvs_tpu/constants.py``.
"""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
