"""Multi-card scaling: unit-batch and image-batch data parallelism.

The reference has no distributed code at all (SURVEY.md section 2b): it
loops units on one CPU thread (indexing_ui.py:2268, :1669). The scaling
axes are

- the **unit batch**: every per-unit pipeline stage is independent, so
  sharding the leading [units] dimension across cards with jax.sharding
  turns the whole inspection into pure data parallelism — zero collectives
  on the hot path, and only the tiny per-unit outputs (verdicts,
  centroids, shifts) are gathered at the end;
- the **image batch** (BASELINE.json config 5, multi-image streaming): a 2D
  ("image", "unit") mesh shards a [images, units, H, W] crop batch both
  ways — each card gathers crops from its local frame and inspects its own
  unit slice.

Both paths use shard_map rather than GSPMD auto-sharding: each card runs
the single-device pipeline, data-dependent while loops included, on its
local slice, and the mesh states the data parallelism outright. On GPUs
XLA hands the output gathers to NCCL; the four cards of one host are
joined all to all by NVLink, so the mesh shape follows the algorithm alone.

Both paths run the REAL workflow: exclusion zones (rects + circles) and
per-unit centroid alignment shifts (indexing_ui.py:2291-2338) are threaded
through, not hardcoded empty.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpu_inspect.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect.engine import (
    InspectionResult,
    SegmentationResult,
    _defect_device,
    _segment_device,
    centroids_from_sums,
    pack_exclusions,
    ref_centroid_arrays,
)


def unit_mesh(devices=None) -> Mesh:
    """1D mesh over all (or given) devices; axis 'unit' shards the unit batch."""
    devices = jax.devices() if devices is None else devices
    return Mesh(np.array(devices), axis_names=("unit",))


def image_unit_mesh(n_images: int, devices=None) -> Mesh:
    """2D ("image", "unit") mesh: n_images rows of devices, units sharded
    within each row. For multi-image streaming (BASELINE.json config 5)."""
    devices = jax.devices() if devices is None else devices
    n = len(devices)
    if n % n_images:
        raise ValueError(f"{n} devices not divisible by {n_images} images")
    grid = np.array(devices).reshape(n_images, n // n_images)
    return Mesh(grid, axis_names=("image", "unit"))


def pad_units(n: int, n_shards: int) -> int:
    """Units are padded to a multiple of the mesh size (padded units are
    all-background crops and produce OK verdicts that callers slice off)."""
    return (n + n_shards - 1) // n_shards * n_shards


def _inspect_shard(crops, rects, circles, ref_centroids, ref_valid, *, seg,
                   defect, is_reference):
    """Per-shard pipeline body: runs on each card's local unit slice, so
    every stage sees an ordinary single-device [U/n, H, W] batch."""
    masks, sums, has_fg, shifts = _segment_device(
        crops,
        rects,
        circles,
        ref_centroids,
        ref_valid,
        seg=seg,
        is_reference=is_reference,
        shape_hw=(crops.shape[1], crops.shape[2]),
    )
    dmasks, found, area, verdict = _defect_device(crops, masks, params=defect)
    return masks, sums, has_fg, shifts, dmasks, found, area, verdict


@functools.partial(
    jax.jit, static_argnames=("seg", "defect", "is_reference", "mesh")
)
def _sharded_inspect(
    crops,
    rects,
    circles,
    ref_centroids,
    ref_valid,
    *,
    seg: SegmentationParams,
    defect: DefectParams,
    is_reference: bool,
    mesh: Mesh,
):
    # shard_map (not GSPMD auto-sharding): each card runs the full pipeline
    # on its local unit slice. Pure data parallelism: zero collectives.
    u = P("unit")
    body = functools.partial(
        _inspect_shard, seg=seg, defect=defect, is_reference=is_reference
    )
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("unit", None, None),
            P(None, None),
            P(None, None),
            P("unit", None),
            u,
        ),
        out_specs=(
            P("unit", None, None),  # masks
            P("unit", None),        # sums
            u,                      # has_fg
            P("unit", None),        # shifts
            P("unit", None, None),  # dmasks
            u,                      # found
            u,                      # area
            u,                      # verdict
        ),
        check_vma=False,
    )(crops, rects, circles, ref_centroids, ref_valid)


def inspect_units_sharded(
    crops: np.ndarray,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids=None,
    is_reference: bool = True,
    mesh: Mesh | None = None,
) -> tuple[SegmentationResult, InspectionResult]:
    """Inspect a unit batch sharded across cards — the full workflow
    (exclusion zones + centroid-alignment shifts included), matching
    engine.inspect_units semantics with the unit axis distributed.

    Returns (SegmentationResult, InspectionResult) as host arrays with
    padding stripped.
    """
    seg = (seg or SegmentationParams()).validated()
    defect = (defect or DefectParams()).validated()
    mesh = mesh or unit_mesh()
    n_shards = mesh.shape.get("unit", mesh.size)
    n = crops.shape[0]
    n_pad = pad_units(n, n_shards)
    rects, circles = pack_exclusions(exclusions)
    ref_arr, ref_ok = ref_centroid_arrays(ref_centroids, n)
    if n_pad != n:
        pad = np.zeros((n_pad - n,) + crops.shape[1:], dtype=crops.dtype)
        crops = np.concatenate([crops, pad], axis=0)
        ref_arr = np.concatenate(
            [ref_arr, np.zeros((n_pad - n, 2), dtype=np.float64)], axis=0
        )
        ref_ok = np.concatenate(
            [ref_ok, np.zeros((n_pad - n,), dtype=bool)], axis=0
        )
    spec = NamedSharding(mesh, P("unit", None, None))
    arr = jax.device_put(jnp.asarray(crops, dtype=jnp.uint8), spec)
    masks, sums, has_fg, shifts, dmasks, found, area, verdict = (
        _sharded_inspect(
            arr,
            jnp.asarray(rects),
            jnp.asarray(circles),
            jnp.asarray(ref_arr),
            jnp.asarray(ref_ok),
            seg=seg,
            defect=defect,
            is_reference=bool(is_reference),
            mesh=mesh,
        )
    )
    seg_res = SegmentationResult(
        masks=np.asarray(masks)[:n],
        centroids=centroids_from_sums(sums)[:n],
        centroid_valid=np.asarray(has_fg)[:n],
        shifts=np.asarray(shifts)[:n],
    )
    insp = InspectionResult(
        defect_masks=np.asarray(dmasks)[:n],
        valid=np.asarray(found)[:n],
        areas=np.asarray(area, dtype=np.int64)[:n],
        verdicts=np.asarray(verdict)[:n],
    )
    return seg_res, insp


# ---------------------------------------------------------------------------
# 2D ("image", "unit") mesh: multi-image batches (BASELINE config 5)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit,
    static_argnames=("seg", "defect", "is_reference", "unit_hw", "mesh"),
)
def _sharded_image_batch(
    images,
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
    mesh: Mesh,
):
    """One shard_map over the 2D mesh: each card holds one image row slice,
    gathers the (cheap) full crop set from its local frame, and runs the
    pipeline on its own unit slice; the only cross-card traffic is the
    output gather."""
    from tpu_inspect.imageio import gather_crops

    n_unit = mesh.shape["unit"]
    upad = origins.shape[0]
    ul = upad // n_unit

    def body(img, origins_r, rects_r, circles_r, refc_r, refv_r):
        crops = gather_crops(img[0], origins_r, unit_hw=unit_hw)
        k = jax.lax.axis_index("unit")

        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, k * ul, ul, axis=0)

        crops_l = jax.lax.optimization_barrier(sl(crops))
        masks, _sums, _has_fg, _shifts = _segment_device(
            crops_l,
            rects_r,
            circles_r,
            sl(refc_r),
            sl(refv_r),
            seg=seg,
            is_reference=is_reference,
            shape_hw=unit_hw,
        )
        dmasks, found, area, verdict = _defect_device(
            crops_l, masks, params=defect
        )
        return (
            verdict[None],
            area[None],
            found[None],
            masks[None],
            dmasks[None],
        )

    rep2 = P(None, None)
    return shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P("image", None, None),
            rep2,
            rep2,
            rep2,
            rep2,
            P(None),
        ),
        out_specs=(
            P("image", "unit"),
            P("image", "unit"),
            P("image", "unit"),
            P("image", "unit", None, None),
            P("image", "unit", None, None),
        ),
        check_vma=False,
    )(images, origins, rects, circles, ref_centroids, ref_valid)


def inspect_image_batch_sharded(
    images: np.ndarray,
    grid: GridParams,
    seg: SegmentationParams | None = None,
    defect: DefectParams | None = None,
    exclusions=(),
    ref_centroids=None,
    mesh: Mesh | None = None,
):
    """Inspect a [B, H, W] batch of full images over a 2D ("image","unit")
    mesh — the crop gather runs per image shard, then all B*U units are
    jointly data-parallel across the whole mesh.

    ``ref_centroids`` anchors apply per unit (shared across images, as every
    streamed frame aligns against the same reference capture). Returns
    (verdicts [B,U] bool, areas [B,U] int64, valid [B,U] bool,
    seg_masks [B,U,h,w], defect_masks [B,U,h,w]).
    """
    from tpu_inspect.geometry import grid_origins

    seg = (seg or SegmentationParams()).validated()
    defect = (defect or DefectParams()).validated()
    mesh = mesh or image_unit_mesh(images.shape[0])
    origins_np = np.asarray(grid_origins(grid))
    u = origins_np.shape[0]
    upad = pad_units(u, mesh.shape["unit"])
    _, _, w, h = grid.base_unit
    rects, circles = pack_exclusions(exclusions)
    ref_arr, ref_ok = ref_centroid_arrays(ref_centroids, u)
    if upad != u:
        origins_np = np.concatenate(
            [origins_np, np.zeros((upad - u, 2), origins_np.dtype)], axis=0
        )
        ref_arr = np.concatenate(
            [ref_arr, np.zeros((upad - u, 2), np.float64)], axis=0
        )
        ref_ok = np.concatenate([ref_ok, np.zeros((upad - u,), bool)], axis=0)
    is_reference = ref_centroids is None
    arr = jax.device_put(
        jnp.asarray(images, dtype=jnp.uint8),
        NamedSharding(mesh, P("image", None, None)),
    )
    verdict, area, found, masks, dmasks = _sharded_image_batch(
        arr,
        jnp.asarray(origins_np),
        jnp.asarray(rects),
        jnp.asarray(circles),
        jnp.asarray(ref_arr),
        jnp.asarray(ref_ok),
        seg=seg,
        defect=defect,
        is_reference=is_reference,
        unit_hw=(h, w),
        mesh=mesh,
    )
    return (
        np.asarray(verdict)[:, :u],
        np.asarray(area, dtype=np.int64)[:, :u],
        np.asarray(found)[:, :u],
        np.asarray(masks)[:, :u],
        np.asarray(dmasks)[:, :u],
    )
