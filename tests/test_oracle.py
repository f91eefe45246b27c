"""Oracle self-validation: the numpy/cv2 oracle must match the reference's
own importable pure functions (its segmentation.py, found through the
``reference_dir`` fixture) exactly.

segmentation.py imports cleanly without Qt (its QImage import is guarded,
segmentation.py:4-7), so segment_cell / fill_internal_holes / mask_stats are
directly comparable. _detect_defects_on_pix needs Qt and is validated
structurally via its cited cv2 call chain plus synthetic cases here.
"""

import importlib.util

import numpy as np
import pytest

from tpu_inspect.config import DefectParams, SegmentationParams
from tpu_inspect.oracle import (
    detect_defects,
    fill_holes,
    inspect_units,
    largest_component_centroid,
    mask_stats,
    segment_unit,
)
from tpu_inspect.synthetic import (
    crop_units,
    make_mold_image,
    random_blob_mask,
    sample_grid_params,
)


@pytest.fixture(scope="module")
def ref_seg(reference_dir):
    """The reference tool's own segmentation module."""
    spec = importlib.util.spec_from_file_location(
        "segmentation", reference_dir / "segmentation.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rand_imgs(n, h=64, w=64, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w), dtype=np.uint8) for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_fill_holes_matches_reference(seed, ref_seg):
    mask = random_blob_mask(48, 56, seed=seed, n_blobs=5)
    # punch holes
    rng = np.random.RandomState(seed + 99)
    holes = random_blob_mask(48, 56, seed=seed + 50, n_blobs=6, scale=0.08)
    mask[holes > 0] = 0
    ours = fill_holes(mask)
    ref = ref_seg.fill_internal_holes(mask)
    np.testing.assert_array_equal(ours, ref)


def test_fill_holes_interior_crop_case(ref_seg):
    # crop fully inside the mold: foreground touches every border; the only
    # background is internal -> everything fills (segmentation.py:54-55 case)
    mask = np.full((20, 20), 255, dtype=np.uint8)
    mask[5:9, 5:9] = 0
    ours = fill_holes(mask)
    ref = ref_seg.fill_internal_holes(mask)
    np.testing.assert_array_equal(ours, ref)
    assert ours.min() == 255


@pytest.mark.parametrize("method", ["otsu", "adaptive"])
@pytest.mark.parametrize("blur,morph", [(0, 0), (3, 3), (4, 5), (31, 2)])
def test_segment_unit_matches_reference(method, blur, morph, ref_seg):
    for img in _rand_imgs(2, seed=blur * 100 + morph):
        p = SegmentationParams(
            method=method, gaussian_blur=blur, morph_kernel=morph,
            adapt_block=51, adapt_C=10,
        )
        ours = segment_unit(img, p)
        ref = ref_seg.segment_cell(
            img, method=method, adapt_block=51, adapt_C=10,
            gaussian_blur=blur, morph_kernel=morph,
        )
        np.testing.assert_array_equal(ours, ref)


def test_segment_unit_mold_like(ref_seg):
    grid = sample_grid_params()
    img = make_mold_image(grid, (3000, 4096), seed=3, defect_rate=1.0)
    crops = crop_units(img, grid)
    p = SegmentationParams()
    for u in [0, 17, 47]:
        ours = segment_unit(crops[u], p)
        ref = ref_seg.segment_cell(crops[u])
        np.testing.assert_array_equal(ours, ref)


def test_mask_stats_matches_reference(ref_seg):
    for m in [np.zeros((5, 5), np.uint8), random_blob_mask(30, 40, seed=2)]:
        assert mask_stats(m) == ref_seg.mask_stats(m)


def test_largest_component_centroid_cases():
    assert largest_component_centroid(np.zeros((4, 4), np.uint8)) is None
    m = np.zeros((10, 10), np.uint8)
    m[1:3, 1:3] = 255  # area 4
    m[5:9, 5:9] = 255  # area 16 -> largest
    assert largest_component_centroid(m) == (6.5, 6.5)


def test_detect_defects_finds_bright_speck():
    grid = sample_grid_params()
    img = make_mold_image(grid, (3000, 4096), seed=7, defect_rate=1.0)
    crops = crop_units(img, grid)
    p_seg = SegmentationParams()
    p_def = DefectParams()
    seg = segment_unit(crops[0], p_seg)
    dm = detect_defects(crops[0], seg, p_def)
    assert dm is not None
    assert mask_stats(dm)["area"] >= p_def.min_area


def test_detect_defects_clean_unit_is_none():
    grid = sample_grid_params()
    img = make_mold_image(grid, (3000, 4096), seed=11, defect_rate=0.0)
    crops = crop_units(img, grid)
    seg = segment_unit(crops[0], SegmentationParams())
    assert detect_defects(crops[0], seg, DefectParams()) is None


def test_detect_defects_empty_roi_returns_none():
    img = _rand_imgs(1)[0]
    empty = np.zeros_like(img)
    assert detect_defects(img, empty, DefectParams()) is None


def test_inspect_units_verdicts():
    grid = sample_grid_params()
    img = make_mold_image(grid, (3000, 4096), seed=5, defect_rate=0.5)
    crops = crop_units(img, grid)[:8]
    masks = np.stack([segment_unit(c, SegmentationParams()) for c in crops])
    dms, areas, verdicts = inspect_units(crops, masks, DefectParams())
    assert len(dms) == 8
    for dm, area, v in zip(dms, areas, verdicts):
        if dm is None:
            assert area == 0 and not v
        else:
            assert area == int((dm > 0).sum())
            assert v == (area >= 20)
    assert verdicts.any() and not verdicts.all()
