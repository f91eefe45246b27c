"""Exact k x k uint8 median blur (cv2.medianBlur parity), batched [U, H, W].

The defect engine's background estimate is ``cv2.medianBlur(gray, 21)``
(indexing_ui.py:1522-1525) — the single heaviest op in the reference chain.
OpenCV uses Huang's running-histogram algorithm on the CPU; here the same
histogram idea is reshaped for data-parallel hardware:

- carry a per-column vertical-window histogram ``[U, W, 256]`` down the rows
  (one lax.scan step per output row: add the entering row, subtract the
  leaving row — each a one-hot compare, fully vectorized),
- per output row, horizontal windowing is a cumsum-then-difference along W
  (border columns replicate-padded), yielding every pixel's full window
  histogram at once,
- the median is ``count(cdf < (k*k+1)//2)`` via a cumsum over the 256 bins.

Exact for any odd k with BORDER_REPLICATE semantics (window values are
clamped-coordinate reads, so the window always holds k*k samples).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def median_blur_u8(x: jnp.ndarray, k: int, rows_per_step: int = 5) -> jnp.ndarray:
    """Exact k x k uint8 median (cv2.medianBlur parity)."""
    return _median_blur_u8_scan(x, k, rows_per_step)


@functools.partial(jax.jit, static_argnames=("k", "rows_per_step"))
def _median_blur_u8_scan(x: jnp.ndarray, k: int, rows_per_step: int = 5) -> jnp.ndarray:
    """x: [U, H, W] uint8 -> [U, H, W] uint8, k odd.

    ``rows_per_step`` output rows are produced per scan step (their column
    histograms are snapshotted from ``rows_per_step`` incremental updates,
    then the cumsum/median extraction runs batched over the block) —
    amortizing per-step overhead without changing total work.
    """
    assert k % 2 == 1 and k >= 1
    if k == 1:
        return x
    u, h, w = x.shape
    r = k // 2
    rank = (k * k + 1) // 2  # 1-based order statistic of the median
    bins = jnp.arange(256, dtype=jnp.int32)
    R = max(1, int(rows_per_step))
    n_steps = (h + R - 1) // R
    h_pad = n_steps * R

    def onehot_row(y):
        # [U, W, 256] int32 counts of row y (clamped = BORDER_REPLICATE)
        row = x[:, jnp.clip(y, 0, h - 1), :].astype(jnp.int32)
        return (row[:, :, None] == bins[None, None, :]).astype(jnp.int32)

    # initial vertical window for output row 0: rows -r..r clamped
    init = onehot_row(0) * (r + 1)
    for dy in range(1, r + 1):
        init = init + onehot_row(dy)

    def block_medians(colhists):
        # colhists: [U, R, W, 256] vertical-window hists for R output rows
        left = jnp.repeat(colhists[:, :, :1], r, axis=2)
        right = jnp.repeat(colhists[:, :, -1:], r, axis=2)
        p = jnp.concatenate([left, colhists, right], axis=2)  # [U,R,W+2r,256]
        cum = jnp.cumsum(p, axis=2)
        zero = jnp.zeros_like(cum[:, :, :1])
        cum = jnp.concatenate([zero, cum], axis=2)
        # window at out col j covers padded cols j..j+k-1 -> cum[j+k]-cum[j]
        win = cum[:, :, k:, :] - cum[:, :, :-k, :]
        cdf = jnp.cumsum(win, axis=3)
        return (cdf < rank).sum(axis=3, dtype=jnp.int32).astype(jnp.uint8)  # [U, R, W]

    def step(colhist, y0):
        # colhist holds the vertical window of output row y0; snapshot R rows
        snaps = []
        ch = colhist
        for j in range(R):
            snaps.append(ch)
            y = y0 + j
            ch = ch + onehot_row(y + r + 1) - onehot_row(y - r)
        meds = block_medians(jnp.stack(snaps, axis=1))
        return ch, meds

    y0s = jnp.arange(n_steps, dtype=jnp.int32) * R
    _, meds = jax.lax.scan(step, init, y0s)  # [steps, U, R, W]
    out = jnp.transpose(meds, (1, 0, 2, 3)).reshape(u, h_pad, w)
    return out[:, :h, :]
