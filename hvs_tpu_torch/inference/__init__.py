"""Serving entry points of the port."""

from .serve import Detector

__all__ = ["Detector"]
