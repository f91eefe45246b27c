"""Thresholding ops: Otsu, adaptive-Gaussian, plain binary (OpenCV parity).

Otsu (cv2.threshold THRESH_OTSU, segmentation.py:82) is reproduced by
replicating OpenCV's getThreshVal_Otsu_8u recurrence *exactly* in float64,
including its FLT_EPSILON guard branches and first-maximum tie-break. The
scan runs vectorized over the unit batch (256 steps of [U]-wide f64 math —
negligible cost, and f64 keeps every intermediate identical to OpenCV's
double-precision loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_FLT_EPSILON = 1.1920928955078125e-07  # FLT_EPSILON, as used by OpenCV


def histogram_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Per-unit 256-bin histogram. x: [U, H, W] uint8 -> [U, 256] int32.

    Factored as a high/low-nibble outer product contracted as a batched
    matmul: hist[v] = sum_px [px>>4 == v>>4] * [px&15 == v&15], so each
    pixel costs 16+16 one-hot compares instead of 256. Precision: the 0/1
    indicators are exact in bf16, and the contraction accumulates in f32
    (``preferred_element_type``), which is exact for counts < 2^24; planes
    with 2^24 or more pixels take the direct int32 one-hot reduce instead.
    """
    u = x.shape[0]
    flat = x.reshape(u, -1)
    if flat.shape[1] >= 1 << 24:
        bins = jnp.arange(256, dtype=jnp.int32)
        f32 = flat.astype(jnp.int32)
        return (f32[:, :, None] == bins[None, None, :]).sum(
            axis=1, dtype=jnp.int32
        )
    i16 = jnp.arange(16, dtype=jnp.uint8)
    hi = (flat >> 4)[:, :, None] == i16
    lo = (flat & 15)[:, :, None] == i16
    h = jnp.einsum(
        "uni,unj->uij",
        hi.astype(jnp.bfloat16),
        lo.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return h.reshape(u, 256).astype(jnp.int32)


def otsu_threshold(x: jnp.ndarray) -> jnp.ndarray:
    """Per-unit Otsu threshold. x: [U, H, W] uint8 -> [U] int32.

    Exact replication of OpenCV getThreshVal_Otsu_8u: ``mu`` accumulated as
    an exact integer then scaled once; per-bin recurrence
    ``mu1 *= q1; q1 += p_i`` with the epsilon guard *skipping* the
    normalization (so mu1 stays in its un-normalized state on guarded bins,
    exactly like the reference's ``continue``); strict ``sigma > max_sigma``
    keeps the first maximum. Uniform images yield threshold 0.
    """
    return otsu_threshold_from_hist(
        histogram_u8(x), x.shape[-2] * x.shape[-1]
    )


def otsu_threshold_from_hist(hist: jnp.ndarray, n: int) -> jnp.ndarray:
    """getThreshVal_Otsu_8u from a precomputed histogram.

    ``hist``: [U, 256] int32 counts, ``n`` the pixel count each histogram
    sums to. Split out of :func:`otsu_threshold` so distributed callers can
    psum per-shard histograms and run the (replicated) recurrence on the
    global counts (parallel/strips.py)."""
    u_real = hist.shape[0]
    if u_real < 8:
        # pad narrow batches to 8 lanes with zero histograms (q1 stays 0
        # there, the epsilon guard holds every step, and lanes never mix);
        # whether this still pays on the GPU has not been timed
        hist = jnp.concatenate(
            [hist, jnp.zeros((8 - u_real, 256), hist.dtype)], axis=0
        )
    u = hist.shape[0]
    scale = jnp.float64(1.0) / jnp.float64(n)
    bins = jnp.arange(256, dtype=jnp.float64)
    mu_raw = (hist.astype(jnp.float64) * bins[None, :]).sum(axis=1)
    mu = mu_raw * scale  # one rounding, like OpenCV's  mu *= scale
    # per-bin operands precomputed vectorized: fl(h_i*scale) and fl(i*p_i)
    # are elementwise f64 multiplies, so hoisting them out of the scan
    # keeps rounding identical while removing the per-step dynamic slice
    # and two multiplies from the sequential chain
    p = hist.T.astype(jnp.float64) * scale  # [256, U]
    ip = bins[:, None] * p  # [256, U] == fl(i_f * p_i)

    def step(carry, xs):
        p_i, ip_i, i = xs
        q1, mu1, max_sigma, max_val = carry
        mu1 = mu1 * q1  # old q1 (un-normalize)
        q1 = q1 + p_i
        q2 = 1.0 - q1
        guard = (jnp.minimum(q1, q2) < _FLT_EPSILON) | (
            jnp.maximum(q1, q2) > 1.0 - _FLT_EPSILON
        )
        mu1_new = (mu1 + ip_i) / q1
        mu2 = (mu - q1 * mu1_new) / q2
        d = mu1_new - mu2
        sigma = q1 * q2 * d * d
        mu1 = jnp.where(guard, mu1, mu1_new)
        better = (~guard) & (sigma > max_sigma)
        max_sigma = jnp.where(better, sigma, max_sigma)
        max_val = jnp.where(better, i, max_val)
        return (q1, mu1, max_sigma, max_val), None

    zeros = jnp.zeros((u,), dtype=jnp.float64)
    init = (zeros, zeros, zeros, jnp.zeros((u,), dtype=jnp.int32))
    # unroll: the 256 tiny [U]-wide f64 steps are latency-bound; unrolling
    # fuses 16 steps per loop iteration without changing the (exactly
    # sequential) summation order
    (q1, mu1, max_sigma, max_val), _ = jax.lax.scan(
        step,
        init,
        (p, ip, jnp.arange(256, dtype=jnp.int32)),
        unroll=16,
    )
    return max_val[:u_real]


def threshold_binary_inv(x: jnp.ndarray, thr: jnp.ndarray) -> jnp.ndarray:
    """THRESH_BINARY_INV: 255 where x <= thr. thr broadcasts over [U]."""
    t = jnp.asarray(thr, dtype=jnp.int32)
    while t.ndim < x.ndim:
        t = t[..., None]
    return jnp.where(x.astype(jnp.int32) <= t, jnp.uint8(255), jnp.uint8(0))


def threshold_binary(x: jnp.ndarray, thr) -> jnp.ndarray:
    """THRESH_BINARY: 255 where x > thr."""
    return jnp.where(
        x.astype(jnp.int32) > jnp.int32(thr), jnp.uint8(255), jnp.uint8(0)
    )


def otsu_binary_inv(x: jnp.ndarray) -> jnp.ndarray:
    """cv2.threshold(x, 0, 255, THRESH_BINARY_INV + THRESH_OTSU) per unit."""
    return threshold_binary_inv(x, otsu_threshold(x))


def adaptive_threshold_inv(
    x: jnp.ndarray, block_size: int, C: int
) -> jnp.ndarray:
    """cv2.adaptiveThreshold(GAUSSIAN_C, BINARY_INV): 255 where x <= mean - C.

    OpenCV's lookup-table formulation is ``255 iff src - mean <= -ceil(C)``
    with the uint8 Gaussian mean (see ops.gaussian.adaptive_gaussian_mean).
    """
    from tpu_inspect.ops.gaussian import adaptive_gaussian_mean

    mean = adaptive_gaussian_mean(x, block_size).astype(jnp.int32)
    diff = x.astype(jnp.int32) - mean
    return jnp.where(diff <= -int(C), jnp.uint8(255), jnp.uint8(0))
