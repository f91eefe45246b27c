"""Grid JSON (v1/v2) and masks+CSV persistence.

Schema parity with the reference:
- v2 export: ``{version: 2, metadata, boxes, exclusions, exclusion_alignment}``
  (indexing_ui.py:2732-2783).
- import accepts a v2 dict, a legacy dict without ``version``, or a bare list
  of boxes (indexing_ui.py:2844-2889). The reference's checked-in sample
  grid.json is the legacy-dict flavor.
- masks+CSV export writes ``mask_%04d.png`` per unit plus a
  ``masks_summary.csv`` with columns index,mask,area,centroid_x,centroid_y
  (indexing_ui.py:2703-2730).
- combined JSON embeds each mask as base64 PNG (indexing_ui.py:2785-2829).
"""

from __future__ import annotations

import base64
import csv
import io
import json
import os
from dataclasses import dataclass, field

import numpy as np

from tpu_inspect.config import GridParams
from tpu_inspect.geometry import infer_grid_params


@dataclass
class GridDocument:
    """In-memory form of a grid JSON file."""

    boxes: list[tuple[int, int, int, int]]  # (x, y, w, h) ordered by index
    metadata: dict = field(default_factory=dict)
    exclusions: list[dict] = field(default_factory=list)
    # {unit_index: (cx, cy)} centroid anchors for exclusion alignment
    ref_centroids: dict[int, tuple[float, float]] = field(default_factory=dict)
    version: int = 2

    @property
    def grid_params(self) -> GridParams | None:
        return infer_grid_params(self.boxes, self.metadata)

    @property
    def unit_shape(self) -> tuple[int, int]:
        """(h, w) of the units; the grid uses a single uniform unit size."""
        if not self.boxes:
            raise ValueError("empty grid")
        _, _, w, h = self.boxes[0]
        return (h, w)


def load_grid(path_or_obj) -> GridDocument:
    """Load a grid JSON in any of the three accepted formats."""
    if isinstance(path_or_obj, (str, os.PathLike)):
        with open(path_or_obj) as f:
            data = json.load(f)
    else:
        data = path_or_obj

    boxes_raw: list = []
    meta: dict = {}
    exclusions: list[dict] = []
    ref_centroids: dict[int, tuple[float, float]] = {}
    version = 1

    if isinstance(data, dict) and "boxes" in data:
        boxes_raw = data["boxes"]
        meta = data.get("metadata", {}) or {}
        exclusions = list(data.get("exclusions", []) or [])
        version = int(data.get("version", 1) or 1)
        align = data.get("exclusion_alignment", {}) or {}
        # alignment anchors only recognized for type seg_centroid_xy
        # (indexing_ui.py:2856-2871)
        if isinstance(align, dict) and align.get("type") == "seg_centroid_xy":
            for k, v in (align.get("ref_centroids", {}) or {}).items():
                try:
                    ref_centroids[int(k)] = (float(v["cx"]), float(v["cy"]))
                except (KeyError, TypeError, ValueError):
                    continue
    elif isinstance(data, list):
        boxes_raw = data

    # Boxes may carry explicit indices; order by them like the reference,
    # which appends in file order and keys results by the index field
    # (indexing_ui.py:2881-2889).
    indexed: list[tuple[int, tuple[int, int, int, int]]] = []
    for item in boxes_raw:
        try:
            idx = item.get("index")
            box = (int(item["x"]), int(item["y"]), int(item["w"]), int(item["h"]))
        except (AttributeError, KeyError, TypeError, ValueError):
            continue
        indexed.append((len(indexed) if idx is None else int(idx), box))
    indexed.sort(key=lambda t: t[0])
    boxes = [b for _, b in indexed]

    return GridDocument(
        boxes=boxes,
        metadata=meta,
        exclusions=exclusions,
        ref_centroids=ref_centroids,
        version=version,
    )


def save_grid(
    doc: GridDocument, path: str | os.PathLike | None = None
) -> dict:
    """Serialize to the v2 schema; writes to ``path`` when given."""
    exports = {
        "version": 2,
        "metadata": dict(doc.metadata),
        "boxes": [
            {"index": i, "x": x, "y": y, "w": w, "h": h}
            for i, (x, y, w, h) in enumerate(doc.boxes)
        ],
        "exclusions": list(doc.exclusions),
        "exclusion_alignment": {
            "type": "seg_centroid_xy",
            "ref_centroids": {
                str(int(k)): {"cx": float(v[0]), "cy": float(v[1])}
                for k, v in doc.ref_centroids.items()
            },
        },
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(exports, f, indent=2)
    return exports


def grid_metadata(
    p, image_width: int | None, image_height: int | None
) -> dict:
    """Build the v2 metadata dict from grid params (indexing_ui.py:2744-2759).

    A :class:`~tpu_inspect.geometry.BoxGrid` (explicit boxes, no indexing
    parameters) exports only the base unit + image size; its geometry lives
    in the boxes list, which re-imports as a BoxGrid again.
    """
    from tpu_inspect.geometry import BoxGrid

    bx, by, bw, bh = p.base_unit
    if isinstance(p, BoxGrid):
        return {
            "image_width": image_width,
            "image_height": image_height,
            "base_unit": {"x": bx, "y": by, "w": bw, "h": bh},
        }
    return {
        "image_width": image_width,
        "image_height": image_height,
        "units_x": p.units_x,
        "units_y": p.units_y,
        "blocks_x": p.blocks_x,
        "blocks_y": p.blocks_y,
        "unit_space_x": p.unit_space_x,
        "unit_space_y": p.unit_space_y,
        "block_space_x": p.block_space_x,
        "block_space_y": p.block_space_y,
        "base_unit": {"x": bx, "y": by, "w": bw, "h": bh},
    }


def _mask_stats(mask: np.ndarray) -> tuple[int, float, float]:
    """area + float64 mean centroid of nonzero pixels (segmentation.py:103-111)."""
    ys, xs = np.nonzero(mask > 0)
    if xs.size == 0:
        return 0, 0.0, 0.0
    return int(xs.size), float(xs.mean()), float(ys.mean())


def _encode_png(mask: np.ndarray) -> bytes:
    import cv2

    ok, buf = cv2.imencode(".png", mask)
    if not ok:
        raise RuntimeError("PNG encode failed")
    return bytes(buf)


def export_masks_and_csv(masks, dirpath: str | os.PathLike) -> str:
    """Write per-unit mask PNGs + masks_summary.csv (indexing_ui.py:2703-2730).

    ``masks`` is a sequence of uint8 [H, W] arrays (or None for units without
    a mask, which are skipped like non-QPixmap items in the reference).
    Returns the CSV path.
    """
    os.makedirs(dirpath, exist_ok=True)
    rows = []
    for i, mask in enumerate(masks):
        if mask is None:
            continue
        fname = f"mask_{i:04d}.png"
        fpath = os.path.join(dirpath, fname)
        m = np.asarray(mask, dtype=np.uint8)
        # first-party native PNG encoder (tpu_inspect.native); byte-level
        # encoder choice is not part of the artifact contract — pixels are
        from tpu_inspect import native

        if m.ndim != 2 or not native.encode_png_gray(fpath, m):
            with open(fpath, "wb") as f:
                f.write(_encode_png(m))
        area, cx, cy = _mask_stats(np.asarray(mask))
        rows.append(
            {"index": i, "mask": fname, "area": area, "centroid_x": cx, "centroid_y": cy}
        )
    csv_path = os.path.join(dirpath, "masks_summary.csv")
    with open(csv_path, "w", newline="") as cf:
        writer = csv.DictWriter(
            cf, fieldnames=["index", "mask", "area", "centroid_x", "centroid_y"]
        )
        writer.writeheader()
        for row in rows:
            writer.writerow(row)
    return csv_path


def export_thumbnails(crops, dirpath: str | os.PathLike) -> int:
    """Write each unit crop as ``unit_%04d.png`` into ``dirpath``
    (export_thumbnails, indexing_ui.py:3127-3140 — the reference's dead
    per-unit thumbnail batch export, here wired into the CLI/server).

    ``crops`` is a sequence of uint8 [H, W] gray arrays (this framework's
    crop store is grayscale end-to-end; the reference saved the color
    QPixmap crop). ``None`` entries are skipped like the reference skips
    non-QPixmap item data. Returns the number of files written.
    """
    os.makedirs(dirpath, exist_ok=True)
    n = 0
    for i, crop in enumerate(crops):
        if crop is None:
            continue
        c = np.asarray(crop, dtype=np.uint8)
        fpath = os.path.join(dirpath, f"unit_{i:04d}.png")
        from tpu_inspect import native

        if c.ndim != 2 or not native.encode_png_gray(fpath, c):
            with open(fpath, "wb") as f:
                f.write(_encode_png(c))
        n += 1
    return n


def export_combined_json(
    doc: GridDocument, masks, path: str | os.PathLike | None = None
) -> dict:
    """Grid + base64-PNG-embedded masks (indexing_ui.py:2785-2829)."""
    masks_out = []
    for i, mask in enumerate(masks):
        if mask is None:
            continue
        b64 = base64.b64encode(_encode_png(np.asarray(mask, dtype=np.uint8)))
        masks_out.append({"index": i, "mask_b64": b64.decode("ascii")})
    exports = {
        "metadata": dict(doc.metadata),
        "boxes": [
            {"index": i, "x": x, "y": y, "w": w, "h": h}
            for i, (x, y, w, h) in enumerate(doc.boxes)
        ],
        "exclusions": list(doc.exclusions),
        "masks": masks_out,
    }
    if path is not None:
        with open(path, "w") as f:
            json.dump(exports, f)
    return exports


def import_combined_json(path_or_obj) -> tuple[GridDocument, dict[int, np.ndarray]]:
    """Load a combined JSON; returns (grid document, {index: mask array})."""
    import cv2

    if isinstance(path_or_obj, (str, os.PathLike)):
        with open(path_or_obj) as f:
            data = json.load(f)
    else:
        data = path_or_obj
    doc = load_grid(data)
    masks: dict[int, np.ndarray] = {}
    for entry in data.get("masks", []) if isinstance(data, dict) else []:
        try:
            raw = base64.b64decode(entry["mask_b64"])
            arr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_GRAYSCALE)
            if arr is not None:
                masks[int(entry["index"])] = arr
        except (KeyError, TypeError, ValueError):
            continue
    return doc, masks


def load_masks_csv(csv_path: str | os.PathLike) -> list[dict]:
    """Read a masks_summary.csv back into a list of row dicts."""
    with open(csv_path, newline="") as cf:
        return [dict(r) for r in csv.DictReader(cf)]
