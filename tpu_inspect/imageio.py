"""Image decode + device crop gather.

Decode parity with the reference's robust loader (ImageWidget.load_image,
indexing_ui.py:145-194): Qt decode first, cv2 fallback for TIFF with
uint16 -> uint8 (/256) or min-max normalization. Here cv2 does all host-side
decoding (it is the same C++ backend the reference ultimately hits) and the
BGR->gray conversion runs on device (ops.color).

The crop gather replaces the per-unit ``QImage.copy`` host loop
(indexing_ui.py:2270): all unit origins go to the device as one [U, 2]
tensor and a vmapped dynamic_slice produces the [U, h, w] crop batch
directly in device memory.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_inspect.config import GridParams
from tpu_inspect.geometry import grid_origins
from tpu_inspect.ops.color import bgr_to_gray


def load_gray(path: str) -> np.ndarray:
    """Decode an image file to uint8 grayscale (reference loader semantics).

    - uint16 inputs: scaled /256 (indexing_ui.py:157-162)
    - float inputs: min-max normalized to 0..255 (indexing_ui.py:163-166)
    - BGR(A) inputs: converted with the fixed-point BT.601 weights

    PNG/TIFF decode goes through the framework's native C++ library
    (tpu_inspect.native, libpng/libtiff) when available; anything it cannot
    reproduce bit-exactly falls back to cv2.
    """
    from tpu_inspect import native

    img = native.decode(path)
    if img is None:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise RuntimeError(f"Unable to load image: {path}")
    return _to_gray_u8(img)


def load_gray_stream(paths, capacity: int = 4, threads: int = 3):
    """Iterate uint8 grayscale frames for a list of image paths.

    Same per-frame semantics as :func:`load_gray`, but decode runs ahead on
    the native worker pool (tpu_inspect.native.StreamLoader) so host decode
    overlaps device compute in streaming deployments. Frames the native
    decoder declines fall back to :func:`load_gray` (cv2) individually;
    unreadable files raise at their position in the stream.
    """
    from tpu_inspect import native

    paths = [str(p) for p in paths]
    for path, raw in zip(paths, native.StreamLoader(paths, capacity, threads)):
        yield _to_gray_u8(raw) if raw is not None else load_gray(path)


def decode_gray(data: bytes) -> np.ndarray:
    """load_gray for in-memory encoded bytes (drag-and-drop uploads,
    indexing_ui.py:1134-1161)."""
    import cv2

    img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise RuntimeError("Unable to decode image data")
    return _to_gray_u8(img)


def _to_gray_u8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint16:
        img = (img / 256).astype(np.uint8)
    elif img.dtype != np.uint8:
        import cv2  # only the float min-max branch needs OpenCV

        img = cv2.normalize(img, None, 0, 255, cv2.NORM_MINMAX).astype(np.uint8)
    if img.ndim == 3:
        if img.shape[2] == 4:
            img = img[:, :, :3]
        img = np.asarray(bgr_to_gray(jnp.asarray(img)))
    return img


@functools.partial(jax.jit, static_argnames=("unit_hw",))
def gather_crops(
    image: jnp.ndarray, origins: jnp.ndarray, *, unit_hw: tuple[int, int]
) -> jnp.ndarray:
    """image [H, W] uint8 + origins [U, 2] (x, y) -> crops [U, h, w] uint8.

    Origins are clamped like dynamic_slice requires; the reference's grids
    always lie inside the image (clamping only protects malformed JSON).
    """
    h, w = unit_hw

    def one(origin):
        return jax.lax.dynamic_slice(image, (origin[1], origin[0]), (h, w))

    return jax.vmap(one)(origins)


def crops_for_grid(image: np.ndarray | jnp.ndarray, grid: GridParams) -> jnp.ndarray:
    """Gather all grid-unit crops of a grayscale image on device."""
    origins = jnp.asarray(grid_origins(grid))
    _, _, w, h = grid.base_unit
    return gather_crops(jnp.asarray(image, dtype=jnp.uint8), origins, unit_hw=(h, w))
