"""Grid JSON v1/v2 round-trip and masks+CSV export parity tests."""

import csv
import json

import numpy as np

from tpu_inspect.persistence import (
    GridDocument,
    export_combined_json,
    export_masks_and_csv,
    grid_metadata,
    import_combined_json,
    load_grid,
    load_masks_csv,
    save_grid,
)
from tpu_inspect.synthetic import sample_grid_params
from tpu_inspect.geometry import grid_boxes


def test_load_legacy_dict_grid(reference_dir):
    doc = load_grid(reference_dir / "grid.json")
    assert doc.version == 1
    assert len(doc.boxes) == 48
    assert doc.exclusions == []
    assert doc.metadata["image_width"] == 4096


def test_load_bare_list():
    doc = load_grid([{ "x": 1, "y": 2, "w": 3, "h": 4}, {"index": 1, "x": 5, "y": 6, "w": 3, "h": 4}])
    assert doc.boxes == [(1, 2, 3, 4), (5, 6, 3, 4)]


def test_v2_round_trip(tmp_path):
    p = sample_grid_params()
    doc = GridDocument(
        boxes=grid_boxes(p),
        metadata=grid_metadata(p, 4096, 3000),
        exclusions=[{"shape": "rect", "x": 1, "y": 2, "w": 3, "h": 4}],
        ref_centroids={0: (10.5, 20.25), 7: (1.0, 2.0)},
    )
    path = tmp_path / "grid_v2.json"
    save_grid(doc, path)
    with open(path) as f:
        raw = json.load(f)
    # schema shape matches the reference export (indexing_ui.py:2771-2780)
    assert raw["version"] == 2
    assert raw["exclusion_alignment"]["type"] == "seg_centroid_xy"
    assert raw["exclusion_alignment"]["ref_centroids"]["0"] == {"cx": 10.5, "cy": 20.25}
    assert raw["boxes"][0] == {"index": 0, "x": 251, "y": 232, "w": 316, "h": 315}

    doc2 = load_grid(path)
    assert doc2.boxes == doc.boxes
    assert doc2.exclusions == doc.exclusions
    assert doc2.ref_centroids == doc.ref_centroids
    assert doc2.grid_params == p


def test_boxes_sorted_by_index_field():
    doc = load_grid(
        {"boxes": [
            {"index": 1, "x": 10, "y": 0, "w": 2, "h": 2},
            {"index": 0, "x": 0, "y": 0, "w": 2, "h": 2},
        ]}
    )
    assert doc.boxes == [(0, 0, 2, 2), (10, 0, 2, 2)]


def test_masks_csv_export_matches_reference_schema(tmp_path):
    masks = [
        np.zeros((8, 8), dtype=np.uint8),
        None,  # skipped like non-QPixmap items (indexing_ui.py:2714-2715)
        np.pad(np.full((2, 3), 255, dtype=np.uint8), ((1, 5), (2, 3))),
    ]
    csv_path = export_masks_and_csv(masks, tmp_path)
    rows = load_masks_csv(csv_path)
    assert [r["index"] for r in rows] == ["0", "2"]
    assert rows[0]["mask"] == "mask_0000.png"
    assert rows[1]["mask"] == "mask_0002.png"
    # area/centroid parity with segmentation.mask_stats (segmentation.py:103-111)
    assert rows[0]["area"] == "0" and rows[0]["centroid_x"] == "0.0"
    assert rows[1]["area"] == "6"
    assert float(rows[1]["centroid_x"]) == 3.0  # xs in {2,3,4}
    assert float(rows[1]["centroid_y"]) == 1.5  # ys in {1,2}
    with open(csv_path) as f:
        header = next(csv.reader(f))
    assert header == ["index", "mask", "area", "centroid_x", "centroid_y"]


def test_thumbnail_export_writes_unit_pngs(tmp_path):
    # export_thumbnails parity (indexing_ui.py:3127-3140): unit_%04d.png
    # per crop, None entries skipped
    import cv2

    from tpu_inspect.persistence import export_thumbnails

    rng = np.random.RandomState(3)
    crops = [
        rng.randint(0, 256, size=(12, 10), dtype=np.uint8),
        None,
        rng.randint(0, 256, size=(12, 10), dtype=np.uint8),
    ]
    n = export_thumbnails(crops, tmp_path)
    assert n == 2
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["unit_0000.png", "unit_0002.png"]
    back = cv2.imread(str(tmp_path / "unit_0002.png"), cv2.IMREAD_UNCHANGED)
    assert np.array_equal(back, crops[2])


def test_combined_json_round_trip(tmp_path):
    p = sample_grid_params()
    doc = GridDocument(boxes=grid_boxes(p), metadata=grid_metadata(p, 4096, 3000))
    rng = np.random.RandomState(0)
    masks = [(rng.rand(16, 16) > 0.5).astype(np.uint8) * 255 for _ in range(3)]
    path = tmp_path / "combined.json"
    export_combined_json(doc, masks, path)
    doc2, masks2 = import_combined_json(path)
    assert doc2.boxes == doc.boxes
    assert set(masks2) == {0, 1, 2}
    for i in range(3):
        np.testing.assert_array_equal(masks2[i], masks[i])


def test_bare_list_grid_keeps_all_units():
    """Legacy bare-list imports must drive every box, not collapse to
    unit 0 (round-1 advisor finding)."""
    from tpu_inspect.geometry import BoxGrid, grid_origins
    from tpu_inspect.persistence import load_grid

    p = sample_grid_params()
    boxes = grid_boxes(p)
    data = [
        {"index": i, "x": x, "y": y, "w": w, "h": h}
        for i, (x, y, w, h) in enumerate(boxes)
    ]
    doc = load_grid(data)
    g = doc.grid_params
    assert isinstance(g, BoxGrid)
    assert g.num_units == len(boxes)
    assert grid_boxes(g) == boxes
    assert grid_origins(g).shape == (len(boxes), 2)
    assert g.base_unit == boxes[0]


def test_stale_metadata_falls_back_to_boxes():
    """Metadata that no longer regenerates the stored boxes is ignored in
    favor of the explicit boxes."""
    from tpu_inspect.geometry import BoxGrid
    from tpu_inspect.persistence import load_grid

    p = sample_grid_params()
    boxes = grid_boxes(p)
    meta = grid_metadata(p, 4096, 3000)
    meta["units_x"] = 1  # stale: regenerates a different grid
    doc = load_grid({"metadata": meta, "boxes": [
        {"index": i, "x": x, "y": y, "w": w, "h": h}
        for i, (x, y, w, h) in enumerate(boxes)
    ]})
    g = doc.grid_params
    assert isinstance(g, BoxGrid)
    assert g.num_units == len(boxes)


def test_matching_metadata_yields_grid_params():
    from tpu_inspect.config import GridParams
    from tpu_inspect.persistence import load_grid

    p = sample_grid_params()
    doc = load_grid(save_grid(GridDocument(
        boxes=grid_boxes(p), metadata=grid_metadata(p, 4096, 3000)
    )))
    assert isinstance(doc.grid_params, GridParams)
    assert doc.grid_params == p
