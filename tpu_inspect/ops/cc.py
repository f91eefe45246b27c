"""Batched 8-connected component labeling + stats (OpenCV parity).

Replaces cv2.connectedComponentsWithStats (indexing_ui.py:1505, :2240) with
an iterative min-label propagation fully vectorized over [U, H, W]:

- init: every foreground pixel is labeled with its linear index y*W+x,
- each round takes a 3x3 neighborhood min (8-connectivity) followed by
  segmented cummin sweeps along rows and columns (a label crosses a whole
  foreground run per sweep, so convergence is O(#bends), not O(diameter)),
- fixpoint: label == min linear index of the component ("root").

Roots are stable identifiers (the component's raster-first pixel). OpenCV
numbers components by first appearance in 2x2-BLOCK raster order (BBDT),
which usually — but not always — agrees with pixel-raster root order;
largest_component reproduces the block order exactly for its area
tie-break (see its docstring).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

import numpy as np

_BIG = np.int32(2**30)  # concrete (not traced): reduce_window needs a const init


def _segment_ids(fg: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Run index along `axis`: increments at every background pixel."""
    return jnp.cumsum((~fg).astype(jnp.int32), axis=axis)


def _seg_cummin(vals: jnp.ndarray, fg: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Min-propagate along `axis` within contiguous fg runs (both directions).

    Segmented running min via ONE cummin per direction: keys are
    ``val - seg_id * K`` with K a power of two larger than any value, so
    keys from earlier runs are strictly larger than every key of the
    current run and never win the prefix min. Background pixels carry the
    value K-1 (the per-run maximum), so they cannot pollute the run that
    follows them. Far cheaper than an associative_scan with a segmented
    operator, which materializes O(log n) intermediates per sweep.

    Stays in int32 when (axis_len + 1) * K < 2^31 (always true for unit
    crops); falls back to int64 keys for whole-image-sized inputs.
    """
    n = vals.shape[axis]
    hw = int(np.prod(vals.shape[1:])) if vals.ndim == 3 else n
    k = 1 << max(2, int(np.ceil(np.log2(hw + 2))))
    use_i64 = (n + 1) * k >= 2**31
    if use_i64 and (2**30 // k) >= 8:
        # whole-image planes: chunk the axis so keys stay int32 (int64
        # scans would move twice the bytes)
        return _seg_cummin_chunked(vals, fg, axis, k)
    dt = jnp.int64 if use_i64 else jnp.int32
    kk = jnp.asarray(k, dtype=dt)

    v = jnp.where(fg, vals, k - 1).astype(dt)

    def directed(rev: bool):
        ids = (
            _segment_ids(fg, axis)
            if not rev
            else jnp.flip(_segment_ids(jnp.flip(fg, axis=axis), axis), axis=axis)
        ).astype(dt)
        key = v - ids * kk
        m = jax.lax.cummin(key, axis=axis, reverse=rev)
        return (m + ids * kk).astype(jnp.int32)

    out = jnp.minimum(directed(False), directed(True))
    return jnp.where(fg, jnp.minimum(out, vals), vals)


def _shift_along(x: jnp.ndarray, d: int, axis: int, fill) -> jnp.ndarray:
    """x shifted +d along `axis`, vacated slots filled with `fill`."""
    sl = jax.lax.slice_in_dim(x, 0, x.shape[axis] - d, axis=axis)
    blk = jnp.full(
        x.shape[:axis] + (d,) + x.shape[axis + 1 :], fill, x.dtype
    )
    return jnp.concatenate([blk, sl], axis=axis)


def _seg_cummin_chunked(
    vals: jnp.ndarray, fg: jnp.ndarray, axis: int, k: int
) -> jnp.ndarray:
    """_seg_cummin for planes where (n+1)*K overflows int32.

    The axis is chunked into blocks of B = 2^30/K elements: within a
    chunk, run ids restart at 0 so ``val - id*K`` stays within int32 and
    one length-B int32 cummin resolves in-chunk prefixes. Cross-chunk
    propagation rides the tiny [.., nb, ..] chunk-summary plane: the min
    of the run portion before chunk c is ``carry(c) = min(tail(c-1),
    carry(c-1) if chunk c-1 is bg-free)`` — an inclusive segmented prefix
    min computed by Hillis-Steele doubling (log2(nb) elementwise rounds,
    no scan op). carry applies exactly to positions still in their
    chunk's leading run (in-chunk id == 0). No int64 anywhere, and no
    full-axis scan: the only scan ops are length-B windows.
    """
    B = 2**30 // k
    n = vals.shape[axis]
    nb = -(-n // B)
    pads = [(0, 0)] * vals.ndim
    pads[axis] = (0, nb * B - n)
    v = jnp.pad(
        jnp.where(fg, vals, k - 1), pads, constant_values=k - 1
    )
    f = jnp.pad(fg, pads, constant_values=False)
    cshape = v.shape[:axis] + (nb, B) + v.shape[axis + 1 :]
    ax_nb, ax_b = axis, axis + 1
    big = jnp.int32(k - 1)

    def forward(vq, fq):
        vq = vq.reshape(cshape)
        fq = fq.reshape(cshape)
        ids_in = jnp.cumsum((~fq).astype(jnp.int32), axis=ax_b)
        key = vq - ids_in * k
        local = jax.lax.cummin(key, axis=ax_b) + ids_in * k
        tail = jax.lax.index_in_dim(local, B - 1, axis=ax_b, keepdims=False)
        bg_free = (
            jax.lax.index_in_dim(ids_in, B - 1, axis=ax_b, keepdims=False)
            == 0
        )
        t = _shift_along(tail, 1, ax_nb, big)
        brk = ~_shift_along(bg_free, 1, ax_nb, False)
        d = 1
        while d < nb:
            t_s = _shift_along(t, d, ax_nb, big)
            b_s = _shift_along(brk, d, ax_nb, True)
            t = jnp.where(brk, t, jnp.minimum(t, t_s))
            brk = brk | b_s
            d *= 2
        carry = jnp.expand_dims(t, ax_b)
        out = jnp.where(
            fq & (ids_in == 0), jnp.minimum(local, carry), local
        )
        return out.reshape(v.shape)

    fwd = forward(v, f)
    rev = jnp.flip(
        forward(jnp.flip(v, axis=axis), jnp.flip(f, axis=axis)), axis=axis
    )
    out = jnp.minimum(fwd, rev)
    out = jax.lax.slice_in_dim(out, 0, n, axis=axis)
    return jnp.where(fg, jnp.minimum(out, vals), vals)


def _nbhd_min(vals: jnp.ndarray) -> jnp.ndarray:
    """3x3 window min (8-neighborhood + self)."""
    p = jnp.pad(vals, ((0, 0), (1, 1), (1, 1)), constant_values=_BIG)
    return jax.lax.reduce_window(
        p, _BIG, jax.lax.min, (1, 3, 3), (1, 1, 1), "VALID"
    )


def label_components(fg: jnp.ndarray) -> jnp.ndarray:
    """fg: [U, H, W] bool -> int32 root labels (y*W+x of raster-first pixel).

    Background pixels get _BIG (2^30).
    """
    u, h, w = fg.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 2)
    init = jnp.where(fg, yy * w + xx, _BIG)
    return _xla_label_fixpoint(fg, init)


def _xla_label_fixpoint(fg: jnp.ndarray, init: jnp.ndarray) -> jnp.ndarray:
    """Min-label propagation to fixpoint (3x3 min + row/col segmented
    cummin sweeps per iteration). Limit = per-component min of init."""

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        labels, _ = state
        new = jnp.where(fg, jnp.minimum(labels, _nbhd_min(labels)), _BIG)
        new = _seg_cummin(new, fg, axis=2)
        new = _seg_cummin(new, fg, axis=1)
        return new, (new != labels).any()

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))
    return labels



def component_areas(labels: jnp.ndarray, fg: jnp.ndarray) -> jnp.ndarray:
    """Per-root pixel counts. Returns [U, H*W] int32 (0 for non-roots).

    Kept for completeness/tests; the hot paths use sorted run-length
    reductions instead of scatter (see largest_component).
    """
    u, h, w = labels.shape
    hw = h * w
    flat = labels.reshape(u, hw)
    fgf = fg.reshape(u, hw)
    idx = jnp.where(fgf, flat, hw)  # spill bucket for background
    areas = jnp.zeros((u, hw + 1), dtype=jnp.int32)
    areas = areas.at[jnp.arange(u, dtype=jnp.int32)[:, None], idx].add(1)
    return areas[:, :hw]


def _run_geometry(sorted_keys: jnp.ndarray):
    """For an ascending-sorted key array [U, N]: per-position run-start
    index, next-run-start index, and new-run flags (all scatter/gather
    free)."""
    u, n = sorted_keys.shape
    idx = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (u, n))
    newrun = jnp.concatenate(
        [jnp.ones((u, 1), bool), sorted_keys[:, 1:] != sorted_keys[:, :-1]], axis=1
    )
    run_start = jax.lax.cummax(jnp.where(newrun, idx, jnp.int32(-1)), axis=1)
    starts_or_big = jnp.where(newrun, idx, jnp.int32(n))
    rcm = jax.lax.cummin(starts_or_big, axis=1, reverse=True)
    next_start = jnp.concatenate(
        [rcm[:, 1:], jnp.full((u, 1), n, dtype=jnp.int32)], axis=1
    )
    return run_start, next_start, newrun


def largest_component_sums(fg: jnp.ndarray):
    """Largest 8-connected component per unit, with integer centroid sums.

    Returns (mask [U,H,W] bool, area [U] int, sx [U] int, sy [U] int,
    has_fg [U] bool) where sx/sy are the EXACT coordinate sums of the
    component's pixels. Callers that persist the reference's float64 mean
    centroid (indexing_ui.py:2235-2248) divide on the host with numpy
    (engine.centroids_from_sums); :func:`largest_component` divides on the
    device for in-pipeline values.

    Implementation: the labels are sorted and run lengths reduced.

    Area ties follow OpenCV exactly: cv2.connectedComponentsWithStats
    (BBDT/Spaghetti, 8-connectivity) numbers components by first appearance
    in **2x2-block raster order** (every 2x2 block is wholly one component
    under 8-connectivity), which np.argmax's first-maximum then picks
    (indexing_ui.py:1508-1509, :2243-2244). Block order can differ from
    pixel-raster order — e.g. first pixels (3,0) vs (2,28): pixel raster
    says (2,28) first, cv2 labels (3,0) first because block (1,0) precedes
    block (1,14) — so the tie-break key is the component's minimum
    block-raster rank, carried through the sort as a value operand.
    """
    u, h, w = fg.shape
    hw = h * w

    labels = label_components(fg)

    yy = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 1)
    xx = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 2)
    bw = (w + 1) // 2
    # block-raster-major pixel rank: block index * 4 + position in block
    blockrank = (
        ((yy >> 1) * bw + (xx >> 1)) * 4 + (yy & 1) * 2 + (xx & 1)
    )
    flat = jnp.where(fg.reshape(u, hw), labels.reshape(u, hw), jnp.int32(hw))
    s, br = jax.lax.sort(
        (flat, blockrank.reshape(u, hw)), dimension=1, num_keys=1
    )
    run_start, next_start, newrun = _run_geometry(s)
    run_len = next_start - run_start
    valid = newrun & (s < hw)
    len_at_start = jnp.where(valid, run_len, 0)
    max_len = len_at_start.max(axis=1)
    is_best = valid & (run_len == max_len[:, None])
    # broadcast each run's is_best flag to every position of the run
    # (2*run_start+flag carried by a cummax), then pick the globally
    # smallest block rank among best-component pixels
    idx = jnp.broadcast_to(jnp.arange(hw, dtype=jnp.int32)[None, :], (u, hw))
    carry = jax.lax.cummax(
        jnp.where(newrun, 2 * idx + is_best.astype(jnp.int32), -1), axis=1
    )
    in_best = (carry & 1) == 1
    tie_key = jnp.where(in_best & (s < hw), br, jnp.int32(2**30))
    win_pos = jnp.argmin(tie_key, axis=1).astype(jnp.int32)
    best_label = jnp.take_along_axis(s, win_pos[:, None], axis=1)[:, 0]
    best_label = jnp.where(max_len > 0, best_label, jnp.int32(hw))

    best_mask = fg & (labels == best_label[:, None, None])
    area = max_len
    xs = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 2)
    ys = jax.lax.broadcasted_iota(jnp.int32, (u, h, w), 1)
    # coordinate sums are exact integers; int32 when they provably fit,
    # else int64 (single-unit whole-image crops)
    sum_dtype = jnp.int32 if max(h, w) * h * w < 2**31 else jnp.int64
    sx = jnp.where(best_mask, xs, 0).sum(axis=(1, 2), dtype=sum_dtype)
    sy = jnp.where(best_mask, ys, 0).sum(axis=(1, 2), dtype=sum_dtype)
    has_fg = fg.any(axis=(1, 2))
    return best_mask, area, sx, sy, has_fg


def largest_component(fg: jnp.ndarray):
    """Largest 8-connected component per unit, with the f64 mean centroid.

    Returns (mask [U,H,W] bool, area [U] int32, centroid [U,2] f64 (cx, cy),
    has_fg [U] bool); centroid is (0, 0) when the unit has no foreground.

    The division runs on the device in IEEE float64, which rounds exactly
    like numpy's mean of the same integer sums.
    """
    best_mask, area, sx, sy, has_fg = largest_component_sums(fg)
    cnt = jnp.maximum(area, 1).astype(jnp.float64)
    cx = sx.astype(jnp.float64) / cnt
    cy = sy.astype(jnp.float64) / cnt
    centroid = jnp.stack([cx, cy], axis=-1)
    return best_mask, area, centroid, has_fg
