"""tpu-inspect: a JAX/XLA vision-inspection framework for accelerators.

Re-implements the capabilities of the classical-CV semiconductor mold
inspection tool (reference: hazernest/Vision-Inspection-system-Segmentation-
using-classical-computer-vision-) as batched, bit-exact device pipelines:

- grid indexing of units on a mold image      (:mod:`tpu_inspect.geometry`)
- per-unit segmentation (Otsu / adaptive)     (:mod:`tpu_inspect.engine`)
- rect/circle exclusion zones + alignment     (:mod:`tpu_inspect.engine`)
- foreign-material defect detection           (:mod:`tpu_inspect.engine`)
- X/O (NG/OK) inspection verdicts             (:mod:`tpu_inspect.engine`)
- grid JSON / masks+CSV import-export         (:mod:`tpu_inspect.persistence`)

The reference's per-unit Python loop over OpenCV C++ calls becomes a single
jitted function over a batched ``[units, H, W]`` uint8 tensor; every OpenCV
primitive on the hot path is re-implemented bit-exactly on device (see
``tpu_inspect.ops``).
"""

# GLOBAL JAX CONFIG: importing this package enables jax_enable_x64.
#
# Bit-exact parity with OpenCV requires float64 for the Otsu threshold scan
# and centroid reductions (OpenCV computes both in double), and int64 for
# the whole-image sort payloads; JAX only exposes 64-bit dtypes behind the
# global x64 flag, and it must be set before any JAX computation. All
# dtypes in this package are explicit, so enabling x64 does not change any
# of OUR ops' precision — but a host program embedding this library
# inherits x64 default-dtype semantics for ITS OWN weakly-typed literals
# (e.g. bare `jnp.arange` becomes int64). If that is unacceptable, import
# tpu_inspect in a separate process. If the environment explicitly demands
# x64 off (JAX_ENABLE_X64=0), importing raises instead of silently
# overriding: without x64 this library would produce WRONG (non-parity)
# anchors and thresholds, which is worse than failing loudly.
import os as _os

import jax as _jax

_x64_env = _os.environ.get("JAX_ENABLE_X64", "").strip().lower()
if _x64_env in ("0", "false", "no"):
    raise ImportError(
        "tpu_inspect requires jax_enable_x64 (float64 Otsu scan / centroid "
        "parity, int64 sort payloads), but JAX_ENABLE_X64 is explicitly "
        "disabled in the environment. Unset it, or run tpu_inspect in its "
        "own process."
    )
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX reads JAX_COMPILATION_CACHE_DIR itself
# when it is set; otherwise the cache lives at a fixed path inside the
# checkout (ignored by git), so every process of a checkout shares it.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    ))

__version__ = "0.1.0"

from tpu_inspect.config import (  # noqa: E402
    DefectParams,
    GridParams,
    InspectionParams,
    SegmentationParams,
)
from tpu_inspect.geometry import grid_boxes  # noqa: E402


def __getattr__(name):
    # Lazy top-level API (avoid importing jax-heavy modules at package import)
    if name in ("inspect_image", "segment_units", "detect_defects_batch"):
        from tpu_inspect import engine

        return getattr(engine, name)
    if name == "InspectionSession":
        from tpu_inspect.session import InspectionSession

        return InspectionSession
    if name == "stream_inspect":
        from tpu_inspect.streaming import stream_inspect

        return stream_inspect
    if name == "load_grid":
        from tpu_inspect.persistence import load_grid

        return load_grid
    raise AttributeError(name)


__all__ = [
    "DefectParams",
    "GridParams",
    "InspectionParams",
    "InspectionSession",
    "SegmentationParams",
    "detect_defects_batch",
    "grid_boxes",
    "inspect_image",
    "load_grid",
    "segment_units",
    "stream_inspect",
]
