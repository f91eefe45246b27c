"""Synthetic mold-image fixtures for tests and benchmarks.

Generates images that structurally resemble the reference workload: a bright
background with a regular grid of darker rounded mold surfaces, optional
bright/dark foreign-material specks, and sensor noise. The sample grid in
the reference's grid.json (4096x3000, 48 units of 316x315) is reproducible
via :func:`sample_grid_params`.
"""

from __future__ import annotations

import numpy as np

from tpu_inspect.config import GridParams
from tpu_inspect.geometry import grid_boxes


def sample_grid_params() -> GridParams:
    """The reference's sample workload (its grid.json metadata)."""
    return GridParams(
        base_unit=(251, 232, 316, 315),
        units_x=4,
        units_y=6,
        blocks_x=2,
        blocks_y=1,
        unit_space_x=133,
        unit_space_y=136,
        block_space_x=252,
        block_space_y=0,
    )


def make_mold_image(
    grid: GridParams,
    image_hw: tuple[int, int] = (3000, 4096),
    *,
    seed: int = 0,
    defect_rate: float = 0.3,
    noise: int = 6,
    shift: tuple[int, int] = (0, 0),
) -> np.ndarray:
    """Render a grayscale mold image [H, W] uint8 for the given grid.

    Each unit gets a dark rounded-rectangle "mold surface" (the segmentation
    foreground — Otsu INV picks dark pixels, segmentation.py:82) with a small
    internal texture; a ``defect_rate`` fraction of units gets a bright
    foreign-material speck inside the surface. ``shift`` translates every
    surface, emulating mold movement between captures (exercises the
    centroid alignment path, indexing_ui.py:2291-2314).
    """
    rng = np.random.RandomState(seed)
    H, W = image_hw
    img = np.full((H, W), 200, dtype=np.float32)
    img += rng.uniform(-8, 8, size=(H, W)).astype(np.float32)

    sx, sy = shift
    for u, (x, y, w, h) in enumerate(grid_boxes(grid)):
        # rounded rect occupying ~70% of the unit
        mx, my = int(w * 0.15) + sx, int(h * 0.15) + sy
        sw, sh = int(w * 0.7), int(h * 0.7)
        yy, xx = np.mgrid[0:h, 0:w]
        rad = min(sw, sh) // 6
        cx0, cx1 = mx + rad, mx + sw - rad
        cy0, cy1 = my + rad, my + sh - rad
        qx = np.clip(xx, cx0, cx1)
        qy = np.clip(yy, cy0, cy1)
        inside = (np.hypot(xx - qx, yy - qy) <= rad) | (
            (xx >= mx) & (xx < mx + sw) & (yy >= cy0) & (yy < cy1)
        ) | ((yy >= my) & (yy < my + sh) & (xx >= cx0) & (xx < cx1))
        y0, y1 = max(0, y), min(H, y + h)
        x0, x1 = max(0, x), min(W, x + w)
        if y1 <= y0 or x1 <= x0:
            continue
        sub = img[y0:y1, x0:x1]
        ins = inside[y0 - y : y1 - y, x0 - x : x1 - x]
        sub[ins] = 80 + rng.uniform(-10, 10)
        # faint texture inside the surface
        sub[ins] += rng.uniform(-5, 5, size=int(ins.sum())).astype(np.float32)
        if rng.rand() < defect_rate:
            # a bright speck (foreign material) inside the surface
            dy_, dx_ = my + rng.randint(rad, sh - rad), mx + rng.randint(rad, sw - rad)
            r = rng.randint(3, 8)
            blob = (xx - dx_) ** 2 + (yy - dy_) ** 2 <= r * r
            blob_clip = blob[y0 - y : y1 - y, x0 - x : x1 - x] & ins
            sub[blob_clip] = 235 + rng.uniform(-5, 5)
        img[y0:y1, x0:x1] = sub

    img += rng.normal(0, noise, size=(H, W)).astype(np.float32)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def crop_units(image: np.ndarray, grid: GridParams) -> np.ndarray:
    """Gather unit crops into a [units, h, w] array (host-side reference)."""
    crops = [image[y : y + h, x : x + w] for x, y, w, h in grid_boxes(grid)]
    return np.stack(crops)


def random_blob_mask(
    h: int, w: int, *, seed: int = 0, n_blobs: int = 4, scale: float = 0.2
) -> np.ndarray:
    """Random smooth binary mask (for per-op parity tests)."""
    rng = np.random.RandomState(seed)
    out = np.zeros((h, w), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_blobs):
        cy, cx = rng.randint(0, h), rng.randint(0, w)
        ry = max(2, int(rng.uniform(0.3, 1.0) * h * scale))
        rx = max(2, int(rng.uniform(0.3, 1.0) * w * scale))
        ang = rng.uniform(0, np.pi)
        dx, dy = xx - cx, yy - cy
        u = dx * np.cos(ang) + dy * np.sin(ang)
        v = -dx * np.sin(ang) + dy * np.cos(ang)
        out[(u / rx) ** 2 + (v / ry) ** 2 <= 1.0] = 255
    return out


def standard_workload():
    """The benchmark/profile standard workload, defined once.

    The reference sample geometry (grid.json: 48 units of 316x315 on a
    4096x3000 image) with one circle exclusion — shared by bench.py and
    the `cli profile` subcommand so both always measure the same program.

    Returns a dict with the raw image, grid, unit origins, the exclusion
    list, and the packed device arrays _inspect_image_device takes.
    """
    from tpu_inspect.engine import pack_exclusions
    from tpu_inspect.geometry import grid_origins

    grid = sample_grid_params()
    image = make_mold_image(grid, (3000, 4096), seed=0, defect_rate=0.3)
    origins = grid_origins(grid)
    u = origins.shape[0]
    exclusions = [{"shape": "circle", "cx": 160, "cy": 160, "r": 30}]
    rects, circles = pack_exclusions(exclusions)
    return {
        "grid": grid,
        "image": image,
        "origins": origins,
        "exclusions": exclusions,
        "rects": rects,
        "circles": circles,
        "ref_centroids": np.zeros((u, 2), dtype=np.float64),
        "ref_valid": np.zeros((u,), dtype=bool),
        "unit_hw": (315, 316),
    }
