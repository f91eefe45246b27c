"""Row-strip sharding of the whole-image configs (BASELINE configs 1/1d).

The unit-batch meshes (parallel/mesh.py) scale the 48-unit grid workload;
a whole-image crop (ONE 4096x3000 unit — the reference's single-unit grid
case, indexing_ui.py:656-659) has no unit axis to shard. Here the IMAGE
ROWS are the shard axis: every raster stage of the segmentation/defect
chain has a bounded vertical dependency cone (gaussian r, adaptive
block//2, morph reach, ROI erode n, median r), so each device owns one
strip of rows and refreshes just its halo rows from its neighbors
(``ppermute``) before each stage. The global steps become collectives:

- Otsu's histogram is a ``psum`` (the f64 recurrence then runs replicated
  on the identical global counts — exact);
- the border-seeded hole-fill flood alternates local sweep fixpoints with
  one-row halo exchanges until a ``psum``'d change flag clears — global
  convergence;
- the defect chain's component analytics (largest-8CC ROI selection,
  Green's contour filter) run replicated after an ``all_gather`` of the
  two raster planes they need; the decomposable stages (the (2n+1)^2
  erode and the 21x21 median-residual march — the dominant cost) stay
  sharded.

At true image borders each stage's own out-of-image semantics (reflect-101
for the blur, replicate for the adaptive mean, the erode/dilate neutrals)
are materialized into the halo/pad rows from local data, so results are
bit-exact vs the single-chip path (and therefore vs OpenCV) on any mesh
size; tests drive the 8-virtual-device CPU mesh (tests/test_parallel
_strips.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_inspect.config import DefectParams, SegmentationParams
from tpu_inspect.ops import morphology, threshold
from tpu_inspect.ops.gaussian import adaptive_gaussian_mean, gaussian_blur_u8
from tpu_inspect.ops.hole_fill import _axis_sweep
from tpu_inspect.ops.common import as_odd

_AXIS = "strip"


def strip_mesh(devices=None) -> Mesh:
    """1D mesh whose axis 'strip' shards image rows."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), axis_names=(_AXIS,))


def _perm_from_above(n):
    """Each device receives its upper neighbor's rows (device 0: zeros)."""
    return [(i, i + 1) for i in range(n - 1)]


def _perm_from_below(n):
    return [(i, i - 1) for i in range(1, n)]


def _virtual_rows(x_l, *, depth: int, offset: int, mode: str, const,
                  edge_row: int, above: bool):
    """``depth`` rows of a stage's out-of-image padding, computed locally.

    ``edge_row`` is the local index of the true image border row (0 for the
    top of the image, Hs_real-1 for the bottom); ``offset`` skips that many
    virtual rows nearest the border (used when part of the virtual band
    already lives in the strip's pad tail). Rows are returned in plane
    order (top-to-bottom)."""
    w = x_l.shape[1]
    if mode == "const":
        return jnp.full((depth, w), const, x_l.dtype)
    if mode == "edge":
        return jnp.broadcast_to(x_l[edge_row : edge_row + 1], (depth, w))
    assert mode == "reflect"  # BORDER_REFLECT_101: virtual row +-d mirrors d
    if above:
        # virtual rows edge-depth-offset .. edge-1-offset (top-to-bottom:
        # farthest first) mirror rows edge+offset+depth .. edge+offset+1
        sl = x_l[edge_row + offset + 1 : edge_row + offset + depth + 1]
        return sl[::-1]
    sl = x_l[edge_row - offset - depth : edge_row - offset]
    return sl[::-1]


def _ext_rows(x_l, halo: int, *, n: int, hs: int, hs_last: int, mode: str,
              const=0):
    """Local strip [Hs, W] -> [Hs + 2*halo, W] with stage-correct halos.

    Interior strip boundaries get REAL neighbor rows (ppermute); the global
    top/bottom borders get the stage's own virtual padding, built from
    local rows (reflect-101 / replicate / constant neutral). On the last
    device, pad-tail rows (beyond the image's real rows) are overwritten
    with the virtual padding first, so its kept outputs see exactly the
    full-plane border semantics. Requires hs_last > halo + (hs - hs_last)
    for reflect stages (one full mirror window inside the last strip)."""
    tail = hs - hs_last  # pad rows on the last device (0 if H % n == 0)
    idx = jax.lax.axis_index(_AXIS)
    if tail:
        fixed = jnp.concatenate(
            [
                x_l[:hs_last],
                _virtual_rows(
                    x_l, depth=tail, offset=0, mode=mode, const=const,
                    edge_row=hs_last - 1, above=False,
                ),
            ],
            axis=0,
        )
        x_l = jnp.where(idx == n - 1, fixed, x_l)
    if halo == 0:
        return x_l
    top = jax.lax.ppermute(x_l[hs - halo :], _AXIS, _perm_from_above(n))
    bot = jax.lax.ppermute(x_l[:halo], _AXIS, _perm_from_below(n))
    top_v = _virtual_rows(
        x_l, depth=halo, offset=0, mode=mode, const=const, edge_row=0,
        above=True,
    )
    # the last device's below-border virtual band continues past its tail
    bot_v = _virtual_rows(
        x_l, depth=halo, offset=tail, mode=mode, const=const,
        edge_row=hs_last - 1, above=False,
    )
    top = jnp.where(idx == 0, top_v, top)
    bot = jnp.where(idx == n - 1, bot_v, bot)
    return jnp.concatenate([top, x_l, bot], axis=0)


def _local_flood_fixpoint(reach, free):
    """Row/column segmented-cummax sweeps to the LOCAL fixpoint."""

    def cond(state):
        return state[1]

    def body(state):
        r, _ = state
        new = _axis_sweep(r, free, axis=1)
        new = _axis_sweep(new, free, axis=0)
        return new, (new != r).any()

    reach, _ = jax.lax.while_loop(cond, body, (reach, jnp.bool_(True)))
    return reach


def _sharded_exterior(fg_l, *, n: int, hs: int, h: int, w: int):
    """Background 4-connected to the GLOBAL image border, strip-sharded.

    ``fg_l``: this strip's foreground mask. Local sweep fixpoints alternate
    with one-row halo exchanges until no strip grows (psum'd flag)."""
    idx = jax.lax.axis_index(_AXIS)
    row_g = idx * hs + jnp.arange(hs, dtype=jnp.int32)[:, None]
    col = jnp.arange(w, dtype=jnp.int32)[None, :]
    valid = row_g < h
    free_l = ~fg_l & valid
    border = (
        (row_g == 0) | (row_g == h - 1) | (col == 0) | (col == w - 1)
    )
    reach = _local_flood_fixpoint(border & free_l, free_l)

    def cond(state):
        return state[1] > 0

    def body(state):
        r, _ = state
        top_in = jax.lax.ppermute(r[-1:], _AXIS, _perm_from_above(n))
        bot_in = jax.lax.ppermute(r[:1], _AXIS, _perm_from_below(n))
        seeded = r.at[0, :].set(r[0] | (free_l[0] & top_in[0]))
        seeded = seeded.at[-1, :].set(
            seeded[-1] | (free_l[-1] & bot_in[0])
        )
        new = _local_flood_fixpoint(seeded, free_l)
        changed = jax.lax.psum(
            (new != r).any().astype(jnp.int32), _AXIS
        )
        return new, changed

    reach, _ = jax.lax.while_loop(cond, body, (reach, jnp.int32(1)))
    return reach, free_l, valid


def _strip_histogram(x_l, valid):
    """[Hs, W] uint8 -> [256] int32 over valid rows only."""
    masked = jnp.where(valid, x_l, jnp.uint8(0))
    hist = threshold.histogram_u8(masked[None])[0]
    n_invalid = (~valid[:, 0]).sum(dtype=jnp.int32) * jnp.int32(
        x_l.shape[1]
    )
    return hist.at[0].add(-n_invalid)


def _segment_strip_body(x_l, *, seg: SegmentationParams, n: int, hs: int,
                        hs_last: int, h: int, w: int):
    """Per-device segmentation chain on one row strip (segment_cell parity,
    segmentation.py:75-100, with cross-strip halos)."""
    ext = functools.partial(_ext_rows, n=n, hs=hs, hs_last=hs_last)
    x = x_l
    if seg.gaussian_blur and seg.gaussian_blur > 0:
        k = as_odd(seg.gaussian_blur)
        r = k // 2
        x = gaussian_blur_u8(ext(x, r, mode="reflect"), k)[r : r + hs]
    idx = jax.lax.axis_index(_AXIS)
    row_g = idx * hs + jnp.arange(hs, dtype=jnp.int32)[:, None]
    valid = row_g < h
    if seg.method == "adaptive":
        bs = max(3, int(seg.adapt_block) | 1)
        r = bs // 2
        mean = adaptive_gaussian_mean(ext(x, r, mode="edge"), bs)[
            r : r + hs
        ].astype(jnp.int32)
        diff = x.astype(jnp.int32) - mean
        mask = jnp.where(
            diff <= -int(seg.adapt_C), jnp.uint8(255), jnp.uint8(0)
        )
    else:
        hist = jax.lax.psum(_strip_histogram(x, valid), _AXIS)
        thr = threshold.otsu_threshold_from_hist(hist[None], h * w)[0]
        mask = jnp.where(
            x.astype(jnp.int32) <= thr, jnp.uint8(255), jnp.uint8(0)
        )
    k = seg.morph_kernel if seg.morph_kernel and seg.morph_kernel > 0 else 1
    k = max(1, int(k))
    if k > 1:
        se = morphology.ellipse_se(k)
        r = k // 2
        for is_erode in (False, True, True, False):  # close then open
            fill = 255 if is_erode else 0
            e = ext(mask, r, mode="const", const=fill)
            op = morphology.erode if is_erode else morphology.dilate
            mask = op(e, se)[r : r + hs]
    fg = mask > 0
    reach, free_l, valid = _sharded_exterior(fg, n=n, hs=hs, h=h, w=w)
    filled = (fg | (free_l & ~reach)) & valid
    return jnp.where(filled, jnp.uint8(255), jnp.uint8(0))


@functools.partial(jax.jit, static_argnames=("seg", "mesh", "h", "w"))
def _segment_image_strips(image_p, *, seg: SegmentationParams, mesh: Mesh,
                          h: int, w: int):
    n = mesh.shape[_AXIS]
    hs = image_p.shape[0] // n
    hs_last = h - (n - 1) * hs
    body = functools.partial(
        _segment_strip_body, seg=seg, n=n, hs=hs, hs_last=hs_last, h=h, w=w
    )
    return shard_map(
        body,
        mesh=mesh,
        in_specs=P(_AXIS, None),
        out_specs=P(_AXIS, None),
        check_vma=False,
    )(image_p)


def _defect_strip_body(x_l, m_l, *, params: DefectParams, n: int, hs: int,
                       hs_last: int, h: int, w: int):
    """Per-device defect chain on one row strip (indexing_ui.py:1471-1572).

    The raster stages shard ((2n+1)^2 ROI erode with const-255 halos, the
    21x21 median-residual mask with replicate halos — the dominant cost of
    the whole-image chain); the component analytics (largest-8CC ROI
    selection, 3x3 open + Green's contour filter) need global connectivity,
    so the two raster planes are all_gathered (uint8, ~12 MB at 4096x3000)
    and that tail runs replicated — identical on every device."""
    from tpu_inspect.ops import canny as canny_op
    from tpu_inspect.ops import cc, contour, median

    ext = functools.partial(_ext_rows, n=n, hs=hs, hs_last=hs_last)
    idx = jax.lax.axis_index(_AXIS)
    row_g = idx * hs + jnp.arange(hs, dtype=jnp.int32)[:, None]
    valid = row_g < h
    thr = int(params.threshold)

    nerode = int(params.erode_px)
    bin_l = jnp.where(m_l > 0, jnp.uint8(255), jnp.uint8(0))
    bin_l = jnp.where(valid, bin_l, jnp.uint8(0))
    if nerode > 0:
        e = ext(bin_l, nerode, mode="const", const=255)
        er_l = morphology.erode_rect3(e, nerode)[nerode : nerode + hs]
    else:
        er_l = bin_l
    er_l = jnp.where(valid, er_l, jnp.uint8(0))

    if params.method == "threshold":
        k = int(params.median_k)
        if k % 2 == 0:
            k += 1
        r = k // 2
        extx = ext(x_l, r, mode="edge")  # medianBlur is BORDER_REPLICATE
        med = median.median_blur_u8(extx[None], k)[0][r : r + hs]
        resid = jnp.abs(x_l.astype(jnp.int32) - med.astype(jnp.int32))
        cand_l = jnp.where(resid > thr, jnp.uint8(255), jnp.uint8(0))
        cand_l = jnp.where(valid, cand_l, jnp.uint8(0))
        cand = jax.lax.all_gather(cand_l, _AXIS, tiled=True)[:h][None]
        needs_open = True
    else:
        # Canny's hysteresis is global: gather the image once and run the
        # whole plane replicated (the cheap path; its flood converges on
        # the full plane exactly as single-chip)
        img = jax.lax.all_gather(x_l, _AXIS, tiled=True)[:h][None]
        cand = canny_op.canny_u8(img, max(1, thr // 2), max(2, thr))
        needs_open = False

    er = jax.lax.all_gather(er_l, _AXIS, tiled=True)[:h][None]

    # ---- replicated component tail (engine._defect_device fallback
    # branch semantics, bit-exact vs the oracle) ----
    roi, _, _, has_fg = cc.largest_component(er > 0)
    roi_empty = ~has_fg
    roi_area = roi.sum(axis=(1, 2), dtype=jnp.int32)
    min_area = int(params.min_area)
    max_area = jnp.maximum(
        jnp.int32(min_area),
        jnp.floor(
            roi_area.astype(jnp.float64) * jnp.float64(params.max_area_frac)
        ).astype(jnp.int32),
    )
    cand = jnp.where(roi, cand, jnp.uint8(0))
    if needs_open:
        cand = morphology.morph_open(cand, morphology.ellipse_se(3))
    out, found = contour.filter_and_select(
        cand > 0, 2 * min_area, 2 * max_area
    )
    found = found & ~roi_empty
    out = jnp.where(found[:, None, None], out, False)
    area = out.sum(axis=(1, 2), dtype=jnp.int32)
    verdict = found & (area >= jnp.int32(min_area))
    out_u8 = jnp.where(out, jnp.uint8(255), jnp.uint8(0))
    return out_u8[0], found[0], area[0], verdict[0]


@functools.partial(
    jax.jit, static_argnames=("params", "mesh", "h", "w")
)
def _defect_image_strips(image_p, mask_p, *, params: DefectParams,
                         mesh: Mesh, h: int, w: int):
    n = mesh.shape[_AXIS]
    hs = image_p.shape[0] // n
    hs_last = h - (n - 1) * hs
    body = functools.partial(
        _defect_strip_body, params=params, n=n, hs=hs, hs_last=hs_last,
        h=h, w=w,
    )
    rep = P(None, None)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(P(_AXIS, None), P(_AXIS, None)),
        out_specs=(rep, P(), P(), P()),
        check_vma=False,
    )(image_p, mask_p)


def defect_image_sharded(
    image: np.ndarray,
    seg_mask: np.ndarray,
    params: DefectParams | None = None,
    mesh: Mesh | None = None,
):
    """Whole-image defect detection (config 1's defect pass) with the
    raster stages row-sharded and the component tail replicated.

    Bit-exact vs ``oracle.detect_defects(image, seg_mask, params)``.
    Returns (defect_mask [H, W] uint8, found bool, area int, verdict bool);
    a False ``found`` corresponds to the oracle's None mask."""
    params = (params or DefectParams()).validated()
    mesh = mesh or strip_mesh()
    n = mesh.shape[_AXIS]
    h, w = image.shape
    hs = -(-h // n)
    hp = hs * n
    hs_last = h - (n - 1) * hs
    k = int(params.median_k) | 1
    max_halo = max(
        int(params.erode_px),
        k // 2 if params.method == "threshold" else 0,
    )
    if hs_last <= max_halo + (hs - hs_last) + 1:
        raise ValueError(
            f"last strip too short for halo {max_halo} "
            f"({hs_last} real rows of {hs}); use fewer devices"
        )
    sh = NamedSharding(mesh, P(_AXIS, None))
    img_p = np.zeros((hp, w), np.uint8)
    img_p[:h] = np.asarray(image, np.uint8)
    msk_p = np.zeros((hp, w), np.uint8)
    msk_p[:h] = np.asarray(seg_mask, np.uint8)
    out, found, area, verdict = _defect_image_strips(
        jax.device_put(jnp.asarray(img_p), sh),
        jax.device_put(jnp.asarray(msk_p), sh),
        params=params, mesh=mesh, h=h, w=w,
    )
    return (
        np.asarray(out),
        bool(found),
        int(area),
        bool(verdict),
    )


def segment_image_sharded(
    image: np.ndarray,
    seg: SegmentationParams | None = None,
    mesh: Mesh | None = None,
) -> np.ndarray:
    """Whole-image segmentation (config 1) with rows sharded across chips.

    Bit-exact vs ``engine.raw_segment(image[None])[0]`` / the OpenCV
    oracle. Returns the [H, W] uint8 mask."""
    seg = (seg or SegmentationParams()).validated()
    mesh = mesh or strip_mesh()
    n = mesh.shape[_AXIS]
    h, w = image.shape
    hs = -(-h // n)
    hp = hs * n
    hs_last = h - (n - 1) * hs
    # reflect-101 stages mirror up to halo+tail rows inside the last strip
    max_halo = max(
        as_odd(seg.gaussian_blur) // 2 if seg.gaussian_blur else 0,
        (max(3, int(seg.adapt_block) | 1) // 2)
        if seg.method == "adaptive"
        else 0,
        max(1, int(seg.morph_kernel or 1)) // 2,
    )
    if hs_last <= max_halo + (hs - hs_last) + 1:
        raise ValueError(
            f"last strip too short for halo {max_halo} "
            f"({hs_last} real rows of {hs}); use fewer devices"
        )
    img_p = np.zeros((hp, w), dtype=np.uint8)
    img_p[:h] = np.asarray(image, dtype=np.uint8)
    arr = jax.device_put(
        jnp.asarray(img_p), NamedSharding(mesh, P(_AXIS, None))
    )
    out = _segment_image_strips(arr, seg=seg, mesh=mesh, h=h, w=w)
    return np.asarray(out)[:h]
