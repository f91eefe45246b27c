"""cv2.Canny parity (L1 gradient, aperture 3), batched over [U, H, W].

Reference call: ``cv2.Canny(gray, max(1, thr//2), max(2, thr))``
(indexing_ui.py:1537). Reproduces OpenCV's scalar pipeline exactly:

- Sobel 3x3 dx/dy with BORDER_REPLICATE,
- L1 magnitude |dx| + |dy|; out-of-image magnitude is 0 (OpenCV's zero
  border rows/cols in the NMS buffer),
- non-maximum suppression with OpenCV's fixed-point sector test
  (TG22 = 13573 = tan(22.5deg) * 2^15) and its exact strict/non-strict
  neighbor comparisons per sector,
- hysteresis: candidates (NMS pass, m > low) 8-connected to a strong
  candidate (m > high) become edges. OpenCV's seed-dedup quirks
  (prev_flag / map[j-mapstep] checks) only skip redundant stack pushes of
  adjacent strong pixels and never change the final connected set.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpu_inspect.ops.hole_fill import propagate8

_TG22 = 13573  # tan(22.5 deg) * 2^15, OpenCV's CANNY_SHIFT fixed point


def _sobel3(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sobel dx, dy (int32), BORDER_REPLICATE."""
    p = jnp.pad(x.astype(jnp.int32), ((0, 0), (1, 1), (1, 1)), mode="edge")
    h, w = x.shape[-2], x.shape[-1]

    def sl(dy, dx):
        return p[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    gx = (
        (sl(-1, 1) - sl(-1, -1))
        + 2 * (sl(0, 1) - sl(0, -1))
        + (sl(1, 1) - sl(1, -1))
    )
    gy = (
        (sl(1, -1) - sl(-1, -1))
        + 2 * (sl(1, 0) - sl(-1, 0))
        + (sl(1, 1) - sl(-1, 1))
    )
    return gx, gy


@functools.partial(jax.jit, static_argnames=("low", "high"))
def canny_u8(x: jnp.ndarray, low: int, high: int) -> jnp.ndarray:
    """x: [U, H, W] uint8 -> edges uint8 0/255. low/high as cv2.Canny."""
    low, high = (int(min(low, high)), int(max(low, high)))
    gx, gy = _sobel3(x)
    mag = jnp.abs(gx) + jnp.abs(gy)

    # neighbors with zero border (OpenCV pads the NMS magnitude buffer with 0)
    mp = jnp.pad(mag, ((0, 0), (1, 1), (1, 1)), constant_values=0)
    h, w = x.shape[-2], x.shape[-1]

    def nb(dy, dx):
        return mp[:, 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ax = jnp.abs(gx)
    ay = jnp.abs(gy) << 15
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << 16)
    s = jnp.where((gx ^ gy) < 0, -1, 1)

    horiz = ay < tg22x
    vert = (~horiz) & (ay > tg67x)
    diag = (~horiz) & (~vert)

    keep_h = (mag > nb(0, -1)) & (mag >= nb(0, 1))
    keep_v = (mag > nb(-1, 0)) & (mag >= nb(1, 0))
    # diagonal: m > mag[y-1, x-s] and m > mag[y+1, x+s]
    up_l = nb(-1, -1)
    up_r = nb(-1, 1)
    dn_l = nb(1, -1)
    dn_r = nb(1, 1)
    keep_d = (mag > jnp.where(s == 1, up_l, up_r)) & (
        mag > jnp.where(s == 1, dn_r, dn_l)
    )

    nms = (horiz & keep_h) | (vert & keep_v) | (diag & keep_d)
    cand = nms & (mag > low)
    strong = cand & (mag > high)
    edges = propagate8(strong, cand)
    return jnp.where(edges, jnp.uint8(255), jnp.uint8(0))
