"""Oracle parity of each XLA stage at the production unit shape (315x316),
on two mold units carrying a defect speck."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_inspect import engine, oracle
from tpu_inspect.config import DefectParams, SegmentationParams
from tpu_inspect.ops import cc, contour, hole_fill, morphology
from tpu_inspect.synthetic import (
    crop_units,
    make_mold_image,
    random_blob_mask,
    sample_grid_params,
)


@pytest.fixture(scope="module")
def units():
    grid = sample_grid_params()
    img = make_mold_image(grid, (3000, 4096), seed=9, defect_rate=1.0)
    crops = crop_units(img, grid)[[3, 30]]
    assert crops.shape == (2, 315, 316)
    seg = SegmentationParams().validated()
    masks = np.stack([oracle.segment_unit(c, seg) for c in crops])
    return crops, masks


def _otsu_mask(crop):
    _, m = cv2.threshold(crop, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
    return m


def check_median_residual(crops, masks):
    params = DefectParams().validated()
    got, needs_open = engine._candidate_mask(jnp.asarray(crops), params)
    assert needs_open
    for c, g in zip(crops, np.asarray(got)):
        resid = cv2.absdiff(c, cv2.medianBlur(c, params.median_k | 1))
        _, ref = cv2.threshold(resid, params.threshold, 255, cv2.THRESH_BINARY)
        np.testing.assert_array_equal(g, ref)


def check_hole_fill(crops, masks):
    pre = np.stack([_otsu_mask(c) for c in crops])
    pre[:, 100:140, 120:170] = 0  # an interior hole in the mold surface
    got = np.asarray(hole_fill.fill_holes(jnp.asarray(pre)))
    for p, g in zip(pre, got):
        np.testing.assert_array_equal(g, oracle.fill_holes(p))


def check_largest_component(crops, masks):
    fg = np.stack([_otsu_mask(c) for c in crops]) > 0
    got, area, sx, sy, has_fg = (
        np.asarray(v) for v in cc.largest_component_sums(jnp.asarray(fg))
    )
    for i, f in enumerate(fg):
        n, labels, stats, _ = cv2.connectedComponentsWithStats(
            f.astype(np.uint8), connectivity=8
        )
        best = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        np.testing.assert_array_equal(got[i], labels == best)
        ys, xs = np.nonzero(labels == best)
        assert (area[i], sx[i], sy[i]) == (xs.size, xs.sum(), ys.sum())


def check_blob_filter(crops, masks):
    fg = np.stack([
        (_otsu_mask(c) > 0) ^ (random_blob_mask(315, 316, seed=i,
                                                  scale=0.08) > 0)
        for i, c in enumerate(crops)
    ])
    lo, hi = 20, 4000
    out, found = contour.filter_and_select(
        jnp.asarray(fg), 2 * lo, jnp.full((2,), 2 * hi, jnp.int32)
    )
    for i, f in enumerate(fg):
        ref = np.zeros(f.shape, np.uint8)
        cnts, _ = cv2.findContours(f.astype(np.uint8), cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
        for c in cnts:
            if lo <= cv2.contourArea(c) <= hi:
                cv2.drawContours(ref, [c], -1, 255, -1)
        np.testing.assert_array_equal(np.asarray(out)[i], ref > 0)
        assert bool(np.asarray(found)[i]) == bool(ref.any())


def check_close_open(crops, masks):
    pre = np.stack([_otsu_mask(c) for c in crops])
    for k in (3, 5):
        se = morphology.ellipse_se(k)
        got = np.asarray(morphology.morph_open(
            morphology.morph_close(jnp.asarray(pre), se), se))
        cse = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        for p, g in zip(pre, got):
            ref = cv2.morphologyEx(p, cv2.MORPH_CLOSE, cse)
            ref = cv2.morphologyEx(ref, cv2.MORPH_OPEN, cse)
            np.testing.assert_array_equal(g, ref)


def check_roi_erode(crops, masks):
    erode_px = DefectParams().validated().erode_px
    roi, empty = engine.defect_roi(jnp.asarray(masks), erode_px)
    for m, r, e in zip(masks, np.asarray(roi), np.asarray(empty)):
        er = cv2.erode(m, None, iterations=erode_px)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(
            (er > 0).astype(np.uint8), connectivity=8
        )
        best = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        np.testing.assert_array_equal(r, labels == best)
        assert not e


@pytest.mark.parametrize("stage", [
    "median_residual", "hole_fill", "largest_component", "blob_filter",
    "close_open", "roi_erode",
])
def test_stage_matches_oracle_at_unit_shape(stage, units):
    globals()[f"check_{stage}"](*units)
