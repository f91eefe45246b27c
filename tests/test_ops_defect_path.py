"""Parity tests for the defect-path ops: median blur + contour analysis."""

import cv2
import numpy as np
import pytest

import jax.numpy as jnp

from tpu_inspect.ops import contour, median
from tpu_inspect.synthetic import random_blob_mask


@pytest.mark.parametrize("k", [3, 5, 9, 21])
def test_median_blur_parity(k):
    imgs = np.random.RandomState(k).randint(0, 256, (3, 50, 57), dtype=np.uint8)
    ref = np.stack([cv2.medianBlur(im, k) for im in imgs])
    ours = np.asarray(median.median_blur_u8(jnp.asarray(imgs), k))
    np.testing.assert_array_equal(ours, ref)


def test_median_blur_uniform_and_binary():
    flat = np.full((1, 30, 30), 77, np.uint8)
    np.testing.assert_array_equal(
        np.asarray(median.median_blur_u8(jnp.asarray(flat), 21)), flat
    )
    binary = (np.random.RandomState(0).rand(1, 40, 40) < 0.5).astype(np.uint8) * 255
    ref = cv2.medianBlur(binary[0], 9)
    ours = np.asarray(median.median_blur_u8(jnp.asarray(binary), 9))[0]
    np.testing.assert_array_equal(ours, ref)


def _external_blob_areas(m):
    cnts, _ = cv2.findContours(
        (m > 0).astype(np.uint8).copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    return sorted(cv2.contourArea(c) for c in cnts)


def _mask_zoo(seed):
    rng = np.random.RandomState(seed)
    zoo = [
        random_blob_mask(45, 53, seed=seed, n_blobs=6),
        (rng.rand(45, 53) < 0.5).astype(np.uint8) * 255,  # dense noise
        np.zeros((20, 20), np.uint8),  # empty
        np.full((20, 20), 255, np.uint8),  # full frame
    ]
    m = random_blob_mask(45, 53, seed=seed + 3, n_blobs=3)
    holes = random_blob_mask(45, 53, seed=seed + 70, n_blobs=6, scale=0.1)
    m[holes > 0] = 0
    zoo.append(m)  # blobs with holes
    single = np.zeros((15, 15), np.uint8)
    single[7, 7] = 255  # single pixel: contourArea 0
    zoo.append(single)
    diag = np.zeros((20, 20), np.uint8)
    for i in range(12):
        diag[i + 3, i + 4] = 255  # diagonal line: contourArea 0
    zoo.append(diag)
    ring = np.zeros((21, 21), np.uint8)  # nested: RETR_EXTERNAL skips inner dot
    yy, xx = np.mgrid[0:21, 0:21]
    d2 = (yy - 10) ** 2 + (xx - 10) ** 2
    ring[(d2 <= 81) & (d2 >= 49)] = 255
    ring[10, 10] = 255
    zoo.append(ring)
    return zoo


@pytest.mark.parametrize("seed", range(3))
def test_contour_areas_match_cv2(seed):
    for m in _mask_zoo(seed * 11):
        ana = contour.analyze_blobs(jnp.asarray(m[None] > 0))
        areas = np.asarray(ana.contour_area)[0]
        isroot = np.asarray(ana.is_root)[0]
        ours = sorted(areas[isroot])
        ref = _external_blob_areas(m)
        assert ours == ref, (ours, ref)


@pytest.mark.parametrize("lo,hi", [(5, 100), (0, 1e9), (20, 50)])
def test_filled_selection_matches_drawcontours(lo, hi):
    for m in _mask_zoo(7):
        ref = np.zeros_like(m)
        cnts, _ = cv2.findContours(
            (m > 0).astype(np.uint8).copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        for c in cnts:
            a = cv2.contourArea(c)
            if lo <= a <= hi:
                cv2.drawContours(ref, [c], -1, 255, -1)
        ana = contour.analyze_blobs(jnp.asarray(m[None] > 0))
        keep = ana.is_root & (ana.contour_area >= lo) & (ana.contour_area <= hi)
        out = np.asarray(contour.select_blobs(ana, keep))[0]
        np.testing.assert_array_equal(out.astype(np.uint8) * 255, ref)


@pytest.mark.parametrize("t1,t2", [(12, 24), (1, 2), (50, 100)])
def test_canny_parity(t1, t2):
    from tpu_inspect.ops import canny

    imgs = np.random.RandomState(t2).randint(0, 256, (2, 40, 44), dtype=np.uint8)
    ref = np.stack([cv2.Canny(im, t1, t2) for im in imgs])
    ours = np.asarray(canny.canny_u8(jnp.asarray(imgs), t1, t2))
    np.testing.assert_array_equal(ours, ref)


def test_largest_component_tie_matches_cv2_block_order():
    """cv2 numbers components in 2x2-block raster order (BBDT); on exact
    area ties np.argmax picks the block-first component even when another
    component's first PIXEL comes earlier in raster order."""
    from tpu_inspect.ops import cc

    img = np.zeros((20, 30), np.uint8)
    img[3:7, 0:3] = 255     # first pixel (3,0) -> block (1,0)
    img[2:8, 28:30] = 255   # first pixel (2,28) -> block (1,14)
    n, labels, stats, _ = cv2.connectedComponentsWithStats(
        (img > 0).astype(np.uint8), connectivity=8
    )
    best = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
    want = labels == best
    mask, area, centroid, has = cc.largest_component(jnp.asarray(img[None] > 0))
    assert bool(has[0])
    np.testing.assert_array_equal(np.asarray(mask[0]), want)


def test_largest_component_random_ties_match_cv2():
    from tpu_inspect.ops import cc

    rng = np.random.RandomState(11)
    for _ in range(20):
        img = np.zeros((24, 32), np.uint8)
        # two random rects of identical area, non-overlapping halves
        w1, h1 = rng.randint(2, 6), rng.randint(2, 6)
        x1, y1 = rng.randint(0, 10), rng.randint(0, 24 - h1)
        img[y1 : y1 + h1, x1 : x1 + w1] = 255
        x2, y2 = rng.randint(17, 32 - w1), rng.randint(0, 24 - h1)
        img[y2 : y2 + h1, x2 : x2 + w1] = 255
        n, labels, stats, _ = cv2.connectedComponentsWithStats(
            (img > 0).astype(np.uint8), connectivity=8
        )
        best = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        mask, _, _, _ = cc.largest_component(jnp.asarray(img[None] > 0))
        np.testing.assert_array_equal(np.asarray(mask[0]), labels == best)


def test_filter_and_select_int64_two_level_scan():
    """filter_and_select on a plane large enough to force the int64
    Green's-sum dtype (big >= 2^31) vs cv2 RETR_EXTERNAL semantics — covers
    the two-level int32-block scan that replaces the emulated int64
    cumsum/cummax)."""
    import jax.numpy as jnp

    h, w = 750, 900  # (nv+1)*2*bias = 677k*4096 >= 2^31 -> int64 branch
    rng = np.random.RandomState(5)
    m = np.zeros((h, w), np.uint8)
    for _ in range(40):
        y, x = rng.randint(0, h - 30), rng.randint(0, w - 30)
        bh, bw = rng.randint(1, 28), rng.randint(1, 28)
        m[y : y + bh, x : x + bw] = 255
    m[200:600, 100:101] = 255  # thin tall blob (area 0 contour)
    for lo, hi in [(5, 1000), (0, 10**9)]:
        ref = np.zeros_like(m)
        cnts, _ = cv2.findContours(
            (m > 0).astype(np.uint8), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
        )
        for c in cnts:
            a = cv2.contourArea(c)
            if lo <= a <= hi:
                cv2.drawContours(ref, [c], -1, 255, -1)
        out, found = contour.filter_and_select(
            jnp.asarray(m[None] > 0),
            jnp.int32(2 * lo),
            jnp.asarray([2 * hi], dtype=jnp.int64).astype(jnp.int32)
            if hi < 2**30
            else jnp.asarray([2**30], jnp.int32),
        )
        np.testing.assert_array_equal(
            np.asarray(out)[0].astype(np.uint8) * 255, ref
        )
        assert bool(np.asarray(found)[0]) == bool(ref.any())


class TestGreenFilterTiled:
    """_green_filter_tiled with tiny tiles vs cv2 RETR_EXTERNAL filtering:
    exercises cross-tile aggregation, ring-only visits, and per-tile
    interior decisions on planes far smaller than the production gate."""

    def _check(self, m, lo_hi_list=((0, 10**9), (5, 120), (20, 60)),
               tiles=((8, 16), (16, 8), (10, 10))):
        import jax.numpy as jnp

        from tpu_inspect.ops import cc
        from tpu_inspect.ops.contour import (
            _green_filter_tiled,
            _vertex_attribution,
        )
        from tpu_inspect.ops.hole_fill import exterior_background

        m = np.asarray(m, np.uint8)
        if m.ndim == 2:
            m = m[None]
        u, h, w = m.shape
        hw = h * w
        fg = jnp.asarray(m > 0)
        ext = exterior_background(fg)
        fill_labels = cc.label_components(~ext)
        fg_labels = cc.label_components(fg)
        top = fg & (fg_labels == fill_labels)
        attr, contrib = _vertex_attribution(top, ext, fill_labels)
        bias = 1 << int(np.ceil(np.log2(h + w + 4)))

        for lo, hi in lo_hi_list:
            refs, fnds = [], []
            for i in range(u):
                ref = np.zeros((h, w), np.uint8)
                cnts, _ = cv2.findContours(
                    m[i], cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
                )
                any_kept = False
                for c in cnts:
                    a = cv2.contourArea(c)
                    if lo <= a <= hi:
                        cv2.drawContours(ref, [c], -1, 255, -1)
                        any_kept = True
                refs.append(ref)
                fnds.append(any_kept)
            maxs = jnp.full((u,), min(2 * hi, 2**30), jnp.int32)
            for tvhw in tiles:
                kv, found = _green_filter_tiled(
                    attr, contrib, hw, bias, jnp.int32(2 * lo), maxs,
                    tile_vhw=tvhw,
                )
                # kept vertices -> kept blobs: a top pixel is kept iff any
                # of its 4 vertices is kept (same rule filter_and_select
                # uses to seed the flood)
                kvn = np.asarray(kv)
                seeds = np.asarray(top) & (
                    kvn[:, :-1, :-1] | kvn[:, :-1, 1:]
                    | kvn[:, 1:, :-1] | kvn[:, 1:, 1:]
                )
                for i in range(u):
                    # every kept blob must be fully seeded, no unkept blob
                    ref_i = refs[i] > 0
                    top_i = np.asarray(top)[i]
                    np.testing.assert_array_equal(
                        seeds[i], top_i & ref_i,
                        err_msg=f"unit {i} lo={lo} hi={hi} tile={tvhw}",
                    )
                    assert bool(np.asarray(found)[i]) == fnds[i]

    def test_blob_spanning_many_tiles(self):
        m = np.zeros((40, 64), np.uint8)
        m[5:35, 3:60] = 255          # giant rectangle across all tiles
        m[10:30, 10:50] = 0          # big hole
        m[15:25, 20:40] = 255        # nested blob inside the hole
        self._check(m, lo_hi_list=((0, 10**9), (100, 10**6), (0, 500)))

    def test_ring_only_visit(self):
        m = np.zeros((32, 32), np.uint8)
        m[15, :] = 255               # 1px line crossing tile cuts
        m[16, 0] = 255               # touches next tile-row only via ring
        self._check(m)

    def test_random_speckle_multiunit(self):
        rng = np.random.RandomState(11)
        m = (rng.rand(3, 30, 40) > 0.6).astype(np.uint8) * 255
        self._check(m)

    def test_dense_random_blobs(self):
        rng = np.random.RandomState(23)
        m = np.zeros((2, 48, 48), np.uint8)
        for i in range(2):
            for _ in range(25):
                y, x = rng.randint(0, 40), rng.randint(0, 40)
                m[i, y:y + rng.randint(2, 9), x:x + rng.randint(2, 9)] = 255
        self._check(m)

    def test_exact_area_boundaries(self):
        # blob area exactly at lo and hi cutoffs, spanning a tile cut
        m = np.zeros((20, 40), np.uint8)
        m[4:8, 6:12] = 255           # contourArea (w-1)*(h-1) = 15
        m[12:16, 20:30] = 255        # contourArea 27
        self._check(m, lo_hi_list=((15, 27), (15, 26), (16, 27), (16, 26)))

    def test_diagonal_and_single_pixels(self):
        m = np.zeros((24, 24), np.uint8)
        for i in range(10):
            m[i + 2, i + 2] = 255    # diagonal line (area 0)
        m[20, 5] = 255               # lone pixel (area 0)
        m[2:5, 15:19] = 255
        self._check(m, lo_hi_list=((0, 10**9), (0, 0), (1, 100)))


def test_seg_cummin_chunked_parity():
    """_seg_cummin on planes big enough to overflow int32 keys routes
    through the chunked int32 formulation (no int64, no full-axis scans);
    must match a brute-force segmented min exactly."""
    import jax.numpy as jnp

    from tpu_inspect.ops import cc

    rng = np.random.RandomState(7)
    h, w = 1200, 1800  # k = 2^22; (w+1)*k >= 2^31 -> chunked on both axes
    hw = h * w
    k = 1 << int(np.ceil(np.log2(hw + 2)))
    assert (w + 1) * k >= 2**31 and (h + 1) * k >= 2**31
    fg = rng.rand(1, h, w) > 0.35
    vals = rng.randint(0, hw, size=(1, h, w)).astype(np.int32)

    def ref_axis(v, f, axis):
        out = v.copy()
        vm = np.moveaxis(out, axis, -1)
        fm = np.moveaxis(f, axis, -1)
        flat_v = vm.reshape(-1, vm.shape[-1])
        flat_f = fm.reshape(-1, fm.shape[-1])
        for r in range(flat_v.shape[0]):
            j = 0
            n = flat_v.shape[1]
            while j < n:
                if not flat_f[r, j]:
                    j += 1
                    continue
                e = j
                while e < n and flat_f[r, e]:
                    e += 1
                m = flat_v[r, j:e].min()
                flat_v[r, j:e] = m
                j = e
        return out

    for axis in (1, 2):
        got = np.asarray(
            cc._seg_cummin(jnp.asarray(vals), jnp.asarray(fg), axis=axis)
        )
        want = ref_axis(vals, fg, axis)
        np.testing.assert_array_equal(got, want)
