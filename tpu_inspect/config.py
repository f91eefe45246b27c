"""Typed configuration for the inspection engine.

Mirrors the reference tool's live widget state (its only "config system"):
defaults and ranges from the reference's indexing_ui.py:662-693 (grid),
:799-806 (segmentation), :870-879 (defect), :1522-1524 (hardcoded median k),
:1548 (hardcoded max-area fraction). Field names follow the reference's grid
JSON metadata schema (indexing_ui.py:2744-2755) so configs round-trip through
persistence unchanged.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal

SegMethod = Literal["otsu", "adaptive"]
DefectMethod = Literal["threshold", "canny"]


def _clamp(v: int, lo: int, hi: int) -> int:
    return max(lo, min(hi, int(v)))


@dataclass(frozen=True)
class SegmentationParams:
    """Per-unit segmentation parameters (reference indexing_ui.py:799-806)."""

    method: SegMethod = "otsu"
    gaussian_blur: int = 3  # 0-31; even values rounded up to odd (segmentation.py:79)
    morph_kernel: int = 3  # 0-31; ellipse SE, close then open (segmentation.py:91-95)
    adapt_block: int = 51  # 3-201; forced odd >=3 (segmentation.py:84)
    adapt_C: int = 10  # -50..50

    def validated(self) -> "SegmentationParams":
        if self.method not in ("otsu", "adaptive"):
            # reference falls back to otsu for unknown methods (segmentation.py:87-89)
            object.__setattr__(self, "method", "otsu")
        return dataclasses.replace(
            self,
            gaussian_blur=_clamp(self.gaussian_blur, 0, 31),
            morph_kernel=_clamp(self.morph_kernel, 0, 31),
            adapt_block=_clamp(self.adapt_block, 3, 201),
            adapt_C=_clamp(self.adapt_C, -50, 50),
        )


@dataclass(frozen=True)
class DefectParams:
    """Foreign-material defect detection parameters (indexing_ui.py:870-875)."""

    method: DefectMethod = "threshold"
    threshold: int = 24  # 0-255 residual threshold / Canny high threshold
    min_area: int = 20  # 0-100000 contour-area filter AND NG verdict threshold
    erode_px: int = 6  # 0-200 ROI erosion iterations of 3x3 rect (indexing_ui.py:1497)
    median_k: int = 21  # hardcoded in the reference (indexing_ui.py:1522-1524)
    max_area_frac: float = 0.98  # hardcoded max-area fraction (indexing_ui.py:1548)

    def validated(self) -> "DefectParams":
        return dataclasses.replace(
            self,
            threshold=_clamp(self.threshold, 0, 255),
            min_area=_clamp(self.min_area, 0, 100000),
            erode_px=_clamp(self.erode_px, 0, 200),
        )


@dataclass(frozen=True)
class GridParams:
    """Grid indexing parameters + base unit (indexing_ui.py:662-693, 2171-2191).

    ``base_unit`` is the user-drawn rect (x, y, w, h) of unit 0; the full grid
    is generated from it by :func:`tpu_inspect.geometry.grid_boxes`.
    """

    base_unit: tuple[int, int, int, int]
    units_x: int = 1  # 0-100
    units_y: int = 1  # 0-100
    blocks_x: int = 1  # 0-50
    blocks_y: int = 1  # 0-50
    unit_space_x: int = 0  # 0-1000
    unit_space_y: int = 0
    block_space_x: int = 0  # 0-2000
    block_space_y: int = 0

    @property
    def num_units(self) -> int:
        return self.units_x * self.units_y * self.blocks_x * self.blocks_y


@dataclass(frozen=True)
class InspectionParams:
    """Full engine configuration: segmentation + defect + exclusions."""

    segmentation: SegmentationParams = SegmentationParams()
    defect: DefectParams = DefectParams()
    # exclusions are dicts in the reference's schema (indexing_ui.py:1811-1816):
    #   {'shape': 'rect', 'x':, 'y':, 'w':, 'h':} or
    #   {'shape': 'circle', 'cx':, 'cy':, 'r':}
    exclusions: tuple[dict, ...] = ()

    def with_exclusions(self, exclusions) -> "InspectionParams":
        return dataclasses.replace(self, exclusions=tuple(exclusions))
