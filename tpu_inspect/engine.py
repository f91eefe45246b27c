"""Fused batched inspection pipelines (the device core).

The reference's per-unit Python loop over ~10 OpenCV calls
(run_segmentation_all, indexing_ui.py:2203-2368) becomes ONE jitted device
function over a [units, H, W] uint8 tensor:

    gather crops -> blur -> threshold -> morphology -> hole fill
    -> largest-component centroid (alignment) -> exclusion masks

All ops are bit-exact vs OpenCV (see tpu_inspect.ops). Static pipeline
configuration (method, kernel sizes, exclusion array capacity) specializes
the compiled program; per-capture data (crops, exclusion geometry,
alignment anchors) are device arrays, so editing an exclusion's geometry or
switching images does NOT recompile. Exclusion arrays are padded to
power-of-two capacities (pack_exclusions), so adding/deleting exclusions
recompiles only when the count crosses a power of two.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from tpu_inspect.config import DefectParams, SegmentationParams
from tpu_inspect.ops import cc, contour, hole_fill, median, morphology, threshold
from tpu_inspect.ops.common import as_odd
from tpu_inspect.ops.gaussian import gaussian_blur_u8


@dataclass
class SegmentationResult:
    """Host-side view of one segmentation pass."""

    masks: np.ndarray  # [U, H, W] uint8 0/255, exclusions applied
    centroids: np.ndarray  # [U, 2] float64 pre-exclusion largest-CC centroid
    centroid_valid: np.ndarray  # [U] bool
    shifts: np.ndarray  # [U, 2] int32 (dx, dy) applied to exclusions

    def centroid_dict(self) -> dict[int, tuple[float, float]]:
        """Anchors in the persistence format {idx: (cx, cy)}."""
        return {
            int(i): (float(c[0]), float(c[1]))
            for i, (c, v) in enumerate(zip(self.centroids, self.centroid_valid))
            if v
        }


def pack_exclusions(exclusions) -> tuple[np.ndarray, np.ndarray]:
    """Split exclusion dicts into (rects [Nr,4] int32, circles [Nc,3] int32).

    Malformed entries are dropped, zero-size rects / r<=0 circles kept (they
    apply as no-ops exactly like the reference's bounds checks,
    indexing_ui.py:2325, :2332).

    The arrays are padded to the next power-of-two capacity with degenerate
    no-op entries (w=h=0 rects, r=0 circles): exclusion_zone unrolls over
    the static row count, so padding means add/delete only recompiles the
    pipeline when the count crosses a power of two, not on every edit.
    """
    rects, circles = [], []
    for e in exclusions or ():
        try:
            if e.get("shape") == "rect":
                rects.append(
                    [int(e.get("x", 0)), int(e.get("y", 0)), int(e.get("w", 0)), int(e.get("h", 0))]
                )
            else:
                circles.append(
                    [int(e.get("cx", 0)), int(e.get("cy", 0)), int(e.get("r", 0))]
                )
        except (AttributeError, TypeError, ValueError):
            continue

    def cap(n: int) -> int:
        return 0 if n == 0 else 1 << (n - 1).bit_length()

    rects += [[0, 0, 0, 0]] * (cap(len(rects)) - len(rects))
    circles += [[0, 0, 0]] * (cap(len(circles)) - len(circles))
    return (
        np.array(rects, dtype=np.int32).reshape(-1, 4),
        np.array(circles, dtype=np.int32).reshape(-1, 3),
    )


def centroids_from_sums(sums: np.ndarray) -> np.ndarray:
    """[U, 3] integer (sx, sy, area) -> exact f64 mean centroids [U, 2].

    Division happens here on the host with numpy, so persisted anchors are
    the reference's own numpy means bit for bit (segmentation.py:103-111)."""
    sums = np.asarray(sums)
    cnt = np.maximum(sums[:, 2], 1).astype(np.float64)
    return np.stack(
        [sums[:, 0].astype(np.float64) / cnt, sums[:, 1].astype(np.float64) / cnt],
        axis=-1,
    )


def ref_centroid_arrays(
    ref_centroids, u: int
) -> tuple[np.ndarray, np.ndarray]:
    """Normalize alignment anchors into ([U,2] float64, [U] bool valid).

    Accepts the persistence dict form {idx: (cx, cy)} (sparse — units whose
    reference mask was empty have no anchor, indexing_ui.py:2282-2289), a
    dense [U,2] array (all valid), or None (no anchors).
    """
    if isinstance(ref_centroids, dict):
        arr = np.zeros((u, 2), dtype=np.float64)
        valid = np.zeros((u,), dtype=bool)
        for k, v in ref_centroids.items():
            if 0 <= int(k) < u:
                arr[int(k)] = (float(v[0]), float(v[1]))
                valid[int(k)] = True
        return arr, valid
    if ref_centroids is None:
        return np.zeros((u, 2), dtype=np.float64), np.zeros((u,), dtype=bool)
    return (
        np.asarray(ref_centroids, dtype=np.float64),
        np.ones((u,), dtype=bool),
    )


def exclusion_zone(
    shape: tuple[int, int],
    rects: jnp.ndarray,
    circles: jnp.ndarray,
    dx: jnp.ndarray,
    dy: jnp.ndarray,
) -> jnp.ndarray:
    """Rasterize per-unit shifted exclusions. Returns [U, H, W] bool.

    Semantics of the apply loop (indexing_ui.py:2316-2338): rect bounds are
    shifted then clamped to the unit (empty when degenerate); circles use
    the integer disc test with no clamping.
    """
    h, w = shape
    u = dx.shape[0]
    xs = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 2)
    ys = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 1)
    dxe = dx[:, None, None]
    dye = dy[:, None, None]
    zone = jnp.zeros((u, h, w), dtype=bool)
    for i in range(rects.shape[0]):
        ex, ey, ew, eh = (rects[i, j] for j in range(4))
        zone = zone | (
            (xs >= ex + dxe)
            & (xs < ex + ew + dxe)
            & (ys >= ey + dye)
            & (ys < ey + eh + dye)
        )
    for i in range(circles.shape[0]):
        cx, cy, r = (circles[i, j] for j in range(3))
        d2 = (xs - (cx + dxe)) ** 2 + (ys - (cy + dye)) ** 2
        zone = zone | ((r > 0) & (d2 <= r * r))
    return zone


def _blur_threshold(crops: jnp.ndarray, seg: SegmentationParams) -> jnp.ndarray:
    """Blur + threshold head of segment_cell (segmentation.py:78-89)."""
    x = crops
    if seg.gaussian_blur and seg.gaussian_blur > 0:
        with jax.named_scope("gauss"):
            x = gaussian_blur_u8(x, as_odd(seg.gaussian_blur))
    with jax.named_scope("thresh"):
        if seg.method == "adaptive":
            bs = max(3, int(seg.adapt_block) | 1)
            return threshold.adaptive_threshold_inv(x, bs, int(seg.adapt_C))
        return threshold.otsu_binary_inv(x)


def _morph_k(seg: SegmentationParams) -> int:
    """Effective morph kernel size (0/1 disables, segmentation.py:91-93)."""
    if not (seg.morph_kernel and seg.morph_kernel > 0):
        return 1
    return max(1, int(seg.morph_kernel))


def raw_segment(crops: jnp.ndarray, seg: SegmentationParams) -> jnp.ndarray:
    """Pre-exclusion segmentation chain (segment_cell parity, segmentation.py:75-100)."""
    mask = _blur_threshold(crops, seg)
    k = _morph_k(seg)
    if k > 1:
        with jax.named_scope("morph"):
            se = morphology.ellipse_se(k)
            mask = morphology.morph_close(mask, se)
            mask = morphology.morph_open(mask, se)
    with jax.named_scope("holefill"):
        return hole_fill.fill_holes(mask)


@functools.partial(
    jax.jit, static_argnames=("seg", "is_reference", "shape_hw")
)
def _segment_device(
    crops,
    rects,
    circles,
    ref_centroids,
    ref_valid,
    *,
    seg: SegmentationParams,
    is_reference: bool,
    shape_hw: tuple[int, int],
):
    mask = raw_segment(crops, seg)
    with jax.named_scope("seg_centroid"):
        _, area, sx, sy, has_fg = cc.largest_component_sums(mask > 0)

    u = crops.shape[0]
    if is_reference:
        dx = jnp.zeros((u,), dtype=jnp.int32)
        dy = jnp.zeros((u,), dtype=jnp.int32)
    else:
        # dx, dy = int(round(c1 - c0)): Python round() == banker's rounding,
        # which jnp.rint matches (indexing_ui.py:2310-2311). The f64
        # division is IEEE correctly rounded on the device, so c1 equals
        # the reference's numpy mean bit for bit.
        cnt = jnp.maximum(area, 1).astype(jnp.float64)
        centroid = jnp.stack(
            [sx.astype(jnp.float64) / cnt, sy.astype(jnp.float64) / cnt],
            axis=-1,
        )
        ok = ref_valid & has_fg
        delta = jnp.rint(centroid - ref_centroids).astype(jnp.int32)
        dx = jnp.where(ok, delta[:, 0], 0)
        dy = jnp.where(ok, delta[:, 1], 0)

    if rects.shape[0] or circles.shape[0]:
        # dx = dy = 0 for every unit on the reference image, so there the
        # rasterized zone is unit-invariant: build it once at [1, H, W] and
        # let the where broadcast (48x less compare volume than the
        # per-unit [U, H, W] rasterization)
        n = 1 if is_reference else u
        with jax.named_scope("exclusions"):
            zone = exclusion_zone(shape_hw, rects, circles, dx[:n], dy[:n])
            mask = jnp.where(zone, jnp.uint8(0), mask)
    # centroid sums leave the device as exact integers; the host divides
    # them with numpy, the reference's own arithmetic (centroids_from_sums)
    sums = jnp.stack(
        [
            sx.astype(jnp.int64),
            sy.astype(jnp.int64),
            area.astype(jnp.int64),
        ],
        axis=-1,
    )
    return mask, sums, has_fg, jnp.stack([dx, dy], axis=-1)


def segment_units(
    crops: np.ndarray | jnp.ndarray,
    seg: SegmentationParams,
    exclusions=(),
    ref_centroids: np.ndarray | dict | None = None,
    is_reference: bool = True,
) -> SegmentationResult:
    """Run the batched segmentation pass (run_segmentation_all parity).

    ``crops``: [U, H, W] uint8 gray. On the reference image the returned
    centroids become the alignment anchors; on other captures pass those
    anchors back via ``ref_centroids`` (array [U, 2] or {idx: (cx, cy)}
    dict) to shift the exclusions per unit.
    """
    crops = jnp.asarray(crops, dtype=jnp.uint8)
    u, h, w = crops.shape
    rects, circles = pack_exclusions(exclusions)
    ref_arr, ref_ok = ref_centroid_arrays(ref_centroids, u)

    mask, sums, has_fg, shifts = _segment_device(
        crops,
        jnp.asarray(rects),
        jnp.asarray(circles),
        jnp.asarray(ref_arr),
        jnp.asarray(ref_ok),
        seg=seg.validated(),
        is_reference=bool(is_reference),
        shape_hw=(h, w),
    )
    return SegmentationResult(
        masks=np.asarray(mask),
        centroids=centroids_from_sums(sums),
        centroid_valid=np.asarray(has_fg),
        shifts=np.asarray(shifts),
    )


# ---------------------------------------------------------------------------
# Defect detection + inspection verdicts
# ---------------------------------------------------------------------------


@dataclass
class InspectionResult:
    """Host-side view of one defect/inspection pass."""

    defect_masks: np.ndarray  # [U, H, W] uint8 0/255 (all-zero when not valid)
    valid: np.ndarray  # [U] bool: reference returned a mask (not None)
    areas: np.ndarray  # [U] int64 defect pixel area (0 when not valid)
    verdicts: np.ndarray  # [U] bool: True = NG

    def defect_mask_list(self) -> list[np.ndarray | None]:
        """Masks in the reference's Optional form (None where no detection)."""
        return [
            self.defect_masks[i] if self.valid[i] else None
            for i in range(self.defect_masks.shape[0])
        ]


def defect_roi(seg_masks: jnp.ndarray, erode_px: int):
    """ROI prep (indexing_ui.py:1480-1516): binarize seg mask, erode
    ``erode_px`` iterations of 3x3 rect, keep the largest 8-connected
    component (holes preserved). Returns (roi [U,H,W] bool, roi_empty [U])."""
    seg_bin = seg_masks > 0
    if erode_px > 0:
        with jax.named_scope("roi_erode"):
            bin_u8 = jnp.where(seg_bin, jnp.uint8(255), jnp.uint8(0))
            seg_bin = morphology.erode_rect3(bin_u8, erode_px) > 0
    with jax.named_scope("roi_largest"):
        largest, _, _, _, has_fg = cc.largest_component_sums(seg_bin)
    return largest, ~has_fg


def _candidate_mask(crops, params: DefectParams):
    """Pre-ROI defect candidate mask (indexing_ui.py:1519-1539).

    Returns (cand [U,H,W] uint8, needs_open): the residual-threshold or
    Canny plane BEFORE the ROI AND and the 3x3 open."""
    thr = int(params.threshold)
    if params.method == "threshold":
        # residual from 21x21 median background (indexing_ui.py:1519-1535)
        k = int(params.median_k)
        if k % 2 == 0:
            k += 1
        with jax.named_scope("median_residual"):
            bg = median.median_blur_u8(crops, k)
            resid = jnp.abs(crops.astype(jnp.int32) - bg.astype(jnp.int32))
            return threshold.threshold_binary(resid, thr), True
    from tpu_inspect.ops import canny as canny_op

    with jax.named_scope("canny"):
        return canny_op.canny_u8(crops, max(1, thr // 2), max(2, thr)), False


@functools.partial(jax.jit, static_argnames=("params",))
def _defect_device(crops, seg_masks, *, params: DefectParams):
    """Defect pass + verdicts (indexing_ui.py:1471-1572, :1669-1700)."""
    with jax.named_scope("defect_roi"):
        roi, roi_empty = defect_roi(seg_masks, int(params.erode_px))
    roi_area = roi.sum(axis=(1, 2), dtype=jnp.int32)

    # area filter (indexing_ui.py:1542-1558): Python int() truncation of
    # roi_area * 0.98 computed in double; comparisons run on exact 2x-areas
    min_area = int(params.min_area)
    max_area = jnp.maximum(
        jnp.int32(min_area),
        jnp.floor(
            roi_area.astype(jnp.float64) * jnp.float64(params.max_area_frac)
        ).astype(jnp.int32),
    )
    cand, needs_open = _candidate_mask(crops, params)

    with jax.named_scope("blob_filter"):
        cand = jnp.where(roi, cand, jnp.uint8(0))
        if needs_open:
            with jax.named_scope("cand_open"):
                cand = morphology.morph_open(cand, morphology.ellipse_se(3))
        out, found = contour.filter_and_select(
            cand > 0, 2 * min_area, 2 * max_area
        )
    found = found & ~roi_empty
    out = jnp.where(found[:, None, None], out, False)
    area = out.sum(axis=(1, 2), dtype=jnp.int32)
    # verdict: NG iff defect area >= min area; None mask => OK
    # (indexing_ui.py:1686-1700)
    verdict = found & (area >= jnp.int32(min_area))
    return jnp.where(out, jnp.uint8(255), jnp.uint8(0)), found, area, verdict


def defect_intermediates(
    crop: np.ndarray,
    seg_mask: np.ndarray,
    params: DefectParams,
) -> dict:
    """Per-stage diagnostic scalars for ONE unit — the reference's verbose
    debug channel (indexing_ui.py:1494, :1535, :1549-1557).

    Returns {'seg_area0', 'erode_px', 'roi_empty', 'roi_area',
    'resid_area' (threshold method only), 'min_area', 'max_area',
    'skipped_large' (list of int contour areas with min_area <= a but
    a > max_area)}. Uses the same proven ops as the batch engine; the cost
    is one single-unit device pass, acceptable for the interactive
    single-unit test this diagnoses.
    """
    from tpu_inspect.ops import contour as contour_op

    params = params.validated()
    crops = jnp.asarray(crop, dtype=jnp.uint8)[None]
    masks = jnp.asarray(seg_mask, dtype=jnp.uint8)[None]
    out = {
        "seg_area0": int((np.asarray(seg_mask) > 0).sum()),
        "erode_px": int(params.erode_px),
        "min_area": int(params.min_area),
    }
    roi, roi_empty = defect_roi(masks, int(params.erode_px))
    out["roi_empty"] = bool(np.asarray(roi_empty)[0])
    out["roi_area"] = int(np.asarray(roi).sum())
    # max_area = max(min_area, int(seg_area * 0.98)) with Python-int
    # truncation of the double product (indexing_ui.py:1548-1549)
    out["max_area"] = max(
        out["min_area"], int(out["roi_area"] * float(params.max_area_frac))
    )
    if out["roi_empty"]:
        return out
    cand, needs_open = _candidate_mask(crops, params)
    cand = jnp.where(roi, cand, jnp.uint8(0))
    if needs_open:
        cand = morphology.morph_open(cand, morphology.ellipse_se(3))
        out["resid_area"] = int((np.asarray(cand) > 0).sum())
    analysis = contour_op.analyze_blobs(cand > 0)
    a2 = np.asarray(analysis.contour_area_x2[0])
    roots = np.asarray(analysis.is_root[0])
    areas = (a2[roots] // 2).astype(int)  # int(contourArea): a2 is exact 2x
    out["skipped_large"] = sorted(
        int(a)
        for a in areas
        if a >= out["min_area"] and a > out["max_area"]
    )
    return out


def detect_defects_batch(
    crops: np.ndarray | jnp.ndarray,
    seg_masks: np.ndarray | jnp.ndarray,
    params: DefectParams,
) -> InspectionResult:
    """Batched _detect_defects_on_pix + verdicts (indexing_ui.py:1471-1572,
    :1669-1700). One device roundtrip for all units."""
    crops = jnp.asarray(crops, dtype=jnp.uint8)
    seg_masks = jnp.asarray(seg_masks, dtype=jnp.uint8)
    masks, found, area, verdict = _defect_device(
        crops, seg_masks, params=params.validated()
    )
    return InspectionResult(
        defect_masks=np.asarray(masks),
        valid=np.asarray(found),
        areas=np.asarray(area),
        verdicts=np.asarray(verdict),
    )


def inspect_units(
    crops: np.ndarray | jnp.ndarray,
    seg: SegmentationParams,
    defect: DefectParams,
    exclusions=(),
    ref_centroids=None,
    is_reference: bool = True,
) -> tuple[SegmentationResult, InspectionResult]:
    """Full inspection: segmentation pass + defect pass + X/O verdicts
    (run_inspection parity, indexing_ui.py:1634-1709)."""
    seg_res = segment_units(
        crops,
        seg,
        exclusions=exclusions,
        ref_centroids=ref_centroids,
        is_reference=is_reference,
    )
    insp = detect_defects_batch(crops, seg_res.masks, defect)
    return seg_res, insp


# ---------------------------------------------------------------------------
# Full-image fused pipeline (crop gather + segmentation + defects, one jit)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("seg", "defect", "is_reference", "unit_hw", "with_defects"),
)
def _inspect_image_device(
    image,
    origins,
    rects,
    circles,
    ref_centroids,
    ref_valid,
    *,
    seg: SegmentationParams,
    defect: DefectParams,
    is_reference: bool,
    unit_hw: tuple[int, int],
    with_defects: bool,
):
    from tpu_inspect.imageio import gather_crops

    # Barrier: without it XLA may fuse the big-image gather into the
    # downstream loop bodies (median scan, CC/flood fixpoints) and recompute
    # the slice on every iteration.
    with jax.named_scope("gather"):
        crops = jax.lax.optimization_barrier(
            gather_crops(image, origins, unit_hw=unit_hw)
        )
    seg_out = _segment_device(
        crops,
        rects,
        circles,
        ref_centroids,
        ref_valid,
        seg=seg,
        is_reference=is_reference,
        shape_hw=unit_hw,
    )
    if not with_defects:
        return seg_out + (None,)
    masks = jax.lax.optimization_barrier(seg_out[0])
    defect_out = _defect_device(crops, masks, params=defect)
    return seg_out + (defect_out,)


def inspect_image(
    image: np.ndarray | jnp.ndarray,
    grid,
    seg: SegmentationParams,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids=None,
    is_reference: bool = True,
) -> tuple[SegmentationResult, InspectionResult | None]:
    """Full-image inspection: one device roundtrip from the raw grayscale
    image to per-unit masks, defect blobs, and X/O verdicts.

    This is the device replacement for the whole
    run_segmentation_all + run_inspection stack (indexing_ui.py:2203-2368,
    :1634-1709): crop gather, segmentation, exclusion alignment, defect
    detection and verdicts fused into a single jitted program.
    """
    from tpu_inspect.geometry import grid_origins

    image = jnp.asarray(image, dtype=jnp.uint8)
    origins = jnp.asarray(grid_origins(grid))
    u = origins.shape[0]
    _, _, w, h = grid.base_unit
    rects, circles = pack_exclusions(exclusions)
    ref_arr, ref_ok = ref_centroid_arrays(ref_centroids, u)

    out = _inspect_image_device(
        image,
        origins,
        jnp.asarray(rects),
        jnp.asarray(circles),
        jnp.asarray(ref_arr),
        jnp.asarray(ref_ok),
        seg=seg.validated(),
        defect=(defect or DefectParams()).validated(),
        is_reference=bool(is_reference),
        unit_hw=(h, w),
        with_defects=defect is not None,
    )
    mask, sums, has_fg, shifts, defect_out = out
    seg_res = SegmentationResult(
        masks=np.asarray(mask),
        centroids=centroids_from_sums(sums),
        centroid_valid=np.asarray(has_fg),
        shifts=np.asarray(shifts),
    )
    if defect_out is None:
        return seg_res, None
    dmasks, found, area, verdict = defect_out
    insp = InspectionResult(
        defect_masks=np.asarray(dmasks),
        valid=np.asarray(found),
        areas=np.asarray(area, dtype=np.int64),
        verdicts=np.asarray(verdict),
    )
    return seg_res, insp
