"""Shared helpers for device ops (batched [U, H, W] uint8 image tensors)."""

from __future__ import annotations

import numpy as np


def cvround(x: np.ndarray | float):
    """OpenCV's cvRound: round half to even (host-side helper)."""
    return np.rint(x)


def as_odd(k: int) -> int:
    """Reference rounds even Gaussian kernels UP to odd (segmentation.py:79)."""
    k = int(k)
    return k if k % 2 == 1 else k + 1

