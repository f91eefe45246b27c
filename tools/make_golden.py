"""Inputs and golden record of the chip smoke run (`chip_smoke.py`).

Every case of the smoke run is defined here: its input image(s), made from
fixed seeds, and the OpenCV oracle's answer for them (`tpu_inspect.oracle`).
A record holds the SHA-256 of each input image and output mask stack, and
the exact per-unit areas, verdicts, anchors and shifts. `chip_smoke.py`
compares the device pipeline with the live oracle when OpenCV imports, and
with the committed record otherwise; its input digests guard the second
route against a change in how the inputs are made.

Regenerate the committed record (needs OpenCV):

    python tools/make_golden.py [--out tests/data/golden_smoke.json]
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from tpu_inspect.config import DefectParams, SegmentationParams  # noqa: E402
from tpu_inspect.synthetic import (  # noqa: E402
    crop_units,
    make_mold_image,
    standard_workload,
)

GOLDEN = ROOT / "tests" / "data" / "golden_smoke.json"

COMBOS = (
    ("otsu", "threshold"),
    ("otsu", "canny"),
    ("adaptive", "threshold"),
    ("adaptive", "canny"),
)
CASES = tuple(f"units_{s}_{d}" for s, d in COMBOS) + (
    "shifted",
    "whole_image",
    "stream",
)
SHIFT = (7, -4)  # mold movement of the production capture (dx, dy)
STREAM_SEEDS = (1, 2, 3, 4)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def params(seg_method: str = "otsu", defect_method: str = "threshold"):
    return (
        SegmentationParams(method=seg_method).validated(),
        DefectParams(method=defect_method).validated(),
    )


@functools.lru_cache(maxsize=None)
def workload() -> dict:
    """The standard workload: 48 units of 316x315 on a 4096x3000 image
    with one circle exclusion (`synthetic.standard_workload`)."""
    return standard_workload()


@functools.lru_cache(maxsize=None)
def shifted_image() -> np.ndarray:
    """A production capture of the same mold, moved by SHIFT."""
    return make_mold_image(
        workload()["grid"], (3000, 4096), seed=0, defect_rate=0.3, shift=SHIFT
    )


@functools.lru_cache(maxsize=None)
def stream_frames() -> tuple[np.ndarray, ...]:
    return tuple(
        make_mold_image(workload()["grid"], (3000, 4096), seed=s,
                        defect_rate=0.3)
        for s in STREAM_SEEDS
    )


def record(image, seg_masks, defect_masks, valid, areas, verdicts,
           centroids=None, shifts=None) -> dict:
    """The comparable form of one pass: digests of the input and of the
    uint8 mask stacks, exact per-unit arrays. ``centroids`` is a list with
    [cx, cy] per unit, or None where the unit has no anchor."""
    rec = {
        "input_sha256": sha256(np.asarray(image, np.uint8)),
        "seg_masks_sha256": sha256(np.asarray(seg_masks, np.uint8)),
        "defect_masks_sha256": sha256(np.asarray(defect_masks, np.uint8)),
        "valid": [bool(v) for v in valid],
        "areas": [int(a) for a in areas],
        "verdicts": [bool(v) for v in verdicts],
    }
    if centroids is not None:
        rec["centroids"] = [
            None if c is None else [float(c[0]), float(c[1])]
            for c in centroids
        ]
    if shifts is not None:
        rec["shifts"] = np.asarray(shifts, np.int64).tolist()
    return rec


def diff(expected, got, path: str = "") -> list[str]:
    """Paths at which two records differ (empty when bit-identical)."""
    if isinstance(expected, dict) and isinstance(got, dict):
        out = []
        for k in sorted(set(expected) | set(got)):
            if k not in expected or k not in got:
                out.append(f"{path}/{k} (missing)")
            else:
                out += diff(expected[k], got[k], f"{path}/{k}")
        return out
    if expected == got:
        return []
    if isinstance(expected, list) and isinstance(got, list):
        if len(expected) == len(got) and all(
            not isinstance(e, (dict, list)) or e is None for e in expected
        ):
            bad = sum(e != g for e, g in zip(expected, got))
            return [f"{path} ({bad} of {len(expected)} differ)"]
        if len(expected) == len(got):
            out = []
            for i, (e, g) in enumerate(zip(expected, got)):
                out += diff(e, g, f"{path}[{i}]")
            return out
    return [path or "/"]


# ---------------------------------------------------------------------------
# the oracle's side (needs OpenCV)
# ---------------------------------------------------------------------------


def _oracle_units(image, seg, defect, ref_centroids=None, is_reference=True):
    from tpu_inspect import oracle

    wl = workload()
    crops = crop_units(image, wl["grid"])
    masks, anchors, shifts = oracle.segment_all_units(
        crops, seg, exclusions=wl["exclusions"],
        ref_centroids=ref_centroids, is_reference=is_reference,
    )
    dms, areas, verdicts = oracle.inspect_units(crops, masks, defect)
    dstack = np.stack(
        [np.zeros_like(crops[0]) if d is None else d for d in dms]
    )
    centroids = [anchors.get(i) for i in range(crops.shape[0])]
    return masks, dstack, [d is not None for d in dms], areas, verdicts, \
        centroids, shifts, anchors


def _reference_anchors() -> dict:
    seg, defect = params()
    return _oracle_units(workload()["image"], seg, defect)[7]


def oracle_record(case: str) -> dict:
    """The oracle's record of one case, computed now."""
    from tpu_inspect import oracle

    wl = workload()
    if case.startswith("units_"):
        _, seg_m, def_m = case.split("_")
        seg, defect = params(seg_m, def_m)
        m, d, v, a, vd, c, _, _ = _oracle_units(wl["image"], seg, defect)
        return record(wl["image"], m, d, v, a, vd, centroids=c)
    seg, defect = params()
    if case == "shifted":
        m, d, v, a, vd, _, sh, _ = _oracle_units(
            shifted_image(), seg, defect,
            ref_centroids=_reference_anchors(), is_reference=False,
        )
        return record(shifted_image(), m, d, v, a, vd, shifts=sh)
    if case == "whole_image":
        image = wl["image"]
        mask = oracle.segment_unit(image, seg)
        dms, areas, verdicts = oracle.inspect_units(
            image[None], mask[None], defect
        )
        dm = np.zeros_like(image) if dms[0] is None else dms[0]
        return record(image, mask[None], dm[None], [dms[0] is not None],
                      areas, verdicts)
    if case == "stream":
        frames = []
        for img in stream_frames():
            m, d, v, a, vd, _, _, _ = _oracle_units(img, seg, defect)
            frames.append(record(img, m, d, v, a, vd))
        return {"frames": frames}
    raise KeyError(case)


def load_golden(path=GOLDEN) -> dict:
    with open(path) as f:
        return json.load(f)["cases"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(GOLDEN))
    args = ap.parse_args(argv)
    doc = {
        "about": "OpenCV oracle record of chip_smoke.py's cases; "
                 "regenerate with tools/make_golden.py",
        "cases": {case: oracle_record(case) for case in CASES},
    }
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print(f"wrote {out} ({len(doc['cases'])} cases)")


if __name__ == "__main__":
    main()
