"""Flood-fill hole filling as a batched fixpoint propagation (OpenCV parity).

Reproduces fill_internal_holes (segmentation.py:27-72): background pixels
4-connected to the image border are "exterior"; any remaining background is
a hole and gets filled. The reference flood-fills per border seed through
OpenCV; here reachability is computed for the whole [U, H, W] batch at once:

    reach <- border & ~fg
    repeat: reach <- row_sweep(col_sweep(reach)) until fixpoint

where each sweep extends reachability through whole free runs in one shot
using segmented cummax (a free run is fully reached as soon as it contains
one reached pixel). Convergence takes O(#bends) sweeps, not O(diameter)
pixel steps, so typical masks converge in a handful of iterations.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _axis_sweep(reach: jnp.ndarray, free: jnp.ndarray, axis: int) -> jnp.ndarray:
    """Extend reach through free runs along `axis` (both directions)."""
    n = reach.shape[axis]
    idx_shape = [1] * reach.ndim
    idx_shape[axis] = n
    idx = jnp.arange(n, dtype=jnp.int32).reshape(idx_shape)
    blocked = ~free
    minus_one = jnp.int32(-1)

    def directed(rev: bool) -> jnp.ndarray:
        last_block = jax.lax.cummax(
            jnp.where(blocked, idx if not rev else (n - 1 - idx), minus_one),
            axis=axis,
            reverse=rev,
        )
        last_seed = jax.lax.cummax(
            jnp.where(reach, idx if not rev else (n - 1 - idx), minus_one),
            axis=axis,
            reverse=rev,
        )
        if rev:
            # cummax(reverse=True) of transformed indices: compare directly
            return free & (last_seed > last_block)
        return free & (last_seed > last_block)

    # forward: seed at smaller index than any block since -> reaches here
    fwd = directed(False)
    # backward: mirror indices so cummax(reverse) compares correctly
    bwd = directed(True)
    return reach | fwd | bwd


def exterior_background(fg: jnp.ndarray) -> jnp.ndarray:
    """Background 4-connected to the border. fg: [U, H, W] bool -> bool mask."""
    free = ~fg
    h, w = fg.shape[-2], fg.shape[-1]

    border = jnp.zeros(fg.shape, dtype=bool)
    border = border.at[..., 0, :].set(True)
    border = border.at[..., h - 1, :].set(True)
    border = border.at[..., :, 0].set(True)
    border = border.at[..., :, w - 1].set(True)
    seed = border & free

    def cond(state):
        reach, changed = state
        return changed

    def body(state):
        reach, _ = state
        new = _axis_sweep(reach, free, axis=reach.ndim - 1)
        new = _axis_sweep(new, free, axis=reach.ndim - 2)
        return new, (new != reach).any()

    reach, _ = jax.lax.while_loop(cond, body, (seed, jnp.bool_(True)))
    return reach


def propagate8(seed: jnp.ndarray, domain: jnp.ndarray) -> jnp.ndarray:
    """8-connected reachability of ``seed`` through ``domain`` (batched
    fixpoint: 3x3 dilation, then row and column run sweeps)."""

    def dilate8(m):
        p = jnp.pad(m, ((0, 0), (1, 1), (1, 1)))
        return jax.lax.reduce_window(
            p, False, jax.lax.bitwise_or, (1, 3, 3), (1, 1, 1), "VALID"
        )

    def cond(state):
        return state[1]

    def body(state):
        reach, _ = state
        new = dilate8(reach) & domain
        new = _axis_sweep(new, domain, axis=reach.ndim - 1)
        new = _axis_sweep(new, domain, axis=reach.ndim - 2)
        return new, (new != reach).any()

    reach, _ = jax.lax.while_loop(cond, body, (seed & domain, jnp.bool_(True)))
    return reach


def fill_holes(mask: jnp.ndarray) -> jnp.ndarray:
    """fill_internal_holes parity: uint8 in (any >0 is fg), 0/255 out."""
    fg = mask > 0
    holes = ~fg & ~exterior_background(fg)
    return jnp.where(fg | holes, jnp.uint8(255), jnp.uint8(0))
