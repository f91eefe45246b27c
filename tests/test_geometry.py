"""Grid-indexing and exclusion geometry tests.

The key fixture is the reference tool's grid.json (``reference_dir``): its
48 boxes must be exactly reproducible from its metadata via the indexing
formula (indexing_ui.py:2184-2191).
"""

import json

import numpy as np
import pytest

from tpu_inspect.config import GridParams
from tpu_inspect.geometry import (
    clamp_exclusion_to_base_unit,
    exclusion_from_drawn_rect,
    exclusion_mask,
    grid_boxes,
)
from tpu_inspect.persistence import load_grid
from tpu_inspect.synthetic import sample_grid_params

def test_sample_grid_reproduced_exactly(reference_dir):
    doc = load_grid(reference_dir / "grid.json")
    params = doc.grid_params
    assert params is not None
    boxes = grid_boxes(params)
    assert boxes == doc.boxes
    assert len(boxes) == 48


def test_sample_grid_params_match_metadata(reference_dir):
    with open(reference_dir / "grid.json") as f:
        meta = json.load(f)["metadata"]
    p = sample_grid_params()
    assert p.units_x == meta["units_x"] and p.units_y == meta["units_y"]
    assert p.blocks_x == meta["blocks_x"] and p.blocks_y == meta["blocks_y"]
    bu = meta["base_unit"]
    assert p.base_unit == (bu["x"], bu["y"], bu["w"], bu["h"])


def test_grid_index_order_row_spans_blocks():
    # 2 units x 1, 2 blocks x 1: order must be ux, then bx (indexing_ui.py:2184-2191)
    p = GridParams(
        base_unit=(0, 0, 10, 10), units_x=2, units_y=1, blocks_x=2, blocks_y=1,
        unit_space_x=1, block_space_x=5,
    )
    boxes = grid_boxes(p)
    xs = [b[0] for b in boxes]
    # block pitch = 2*10 + 1*1 + 5 = 26
    assert xs == [0, 11, 26, 37]


def test_grid_vertical_order():
    p = GridParams(
        base_unit=(3, 7, 4, 5), units_x=1, units_y=2, blocks_x=1, blocks_y=2,
        unit_space_y=2, block_space_y=9,
    )
    boxes = grid_boxes(p)
    ys = [b[1] for b in boxes]
    # block pitch y = 2*5 + 1*2 + 9 = 21
    assert ys == [7, 14, 28, 35]


@pytest.mark.parametrize(
    "excl,expected",
    [
        # rect fully inside: unchanged
        ({"shape": "rect", "x": 2, "y": 3, "w": 4, "h": 5}, {"x": 2, "y": 3, "w": 4, "h": 5}),
        # rect origin past the unit: clamped to last pixel, min size 1
        ({"shape": "rect", "x": 50, "y": 50, "w": 10, "h": 10}, {"x": 19, "y": 9, "w": 1, "h": 1}),
        # rect overflowing right/bottom: size clipped
        ({"shape": "rect", "x": 15, "y": 5, "w": 99, "h": 99}, {"x": 15, "y": 5, "w": 5, "h": 5}),
        # negative origin clamped to 0
        ({"shape": "rect", "x": -3, "y": -4, "w": 2, "h": 2}, {"x": 0, "y": 0, "w": 2, "h": 2}),
    ],
)
def test_clamp_rect_exclusion(excl, expected):
    out = clamp_exclusion_to_base_unit(excl, bw=20, bh=10)
    for k, v in expected.items():
        assert out[k] == v, (k, out)


def test_clamp_circle_exclusion():
    # circle near corner: r limited by distances to each edge (indexing_ui.py:1943)
    out = clamp_exclusion_to_base_unit(
        {"shape": "circle", "cx": 3, "cy": 8, "r": 100}, bw=20, bh=10
    )
    assert out["cx"] == 3 and out["cy"] == 8
    assert out["r"] == min(100, 3, 8, 20 - 3 - 1, max(1, 10 - 8 - 1))


def test_exclusion_from_drawn_rect_rect_and_circle():
    base = (100, 100, 50, 40)
    r = exclusion_from_drawn_rect((110, 105, 200, 10), base, "rect")
    assert r == {"shape": "rect", "x": 10, "y": 5, "w": 40, "h": 10}
    c = exclusion_from_drawn_rect((110, 110, 20, 10), base, "circle")
    assert c == {"shape": "circle", "cx": 20, "cy": 15, "r": 5}
    assert exclusion_from_drawn_rect((0, 0, 50, 50), base) is None


def test_exclusion_mask_matches_manual_apply():
    h, w = 30, 40
    excls = [
        {"shape": "rect", "x": 5, "y": 5, "w": 10, "h": 8},
        {"shape": "circle", "cx": 30, "cy": 20, "r": 6},
    ]
    m = exclusion_mask(excls, h, w, dx=2, dy=-1)
    ref = np.zeros((h, w), dtype=bool)
    ref[4:12, 7:17] = True  # rect shifted by (2,-1)
    yy, xx = np.ogrid[:h, :w]
    ref |= (xx - 32) ** 2 + (yy - 19) ** 2 <= 36
    assert (m == ref).all()


def test_exclusion_mask_skips_malformed():
    m = exclusion_mask([{"shape": "rect"}, {"bogus": 1}, None], 10, 10)
    assert m.sum() == 0  # zero-size rect excluded, malformed skipped
