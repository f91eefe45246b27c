"""Multi-image session workflow + CLI tests (component #17, #18, #19)."""

import json
import os

import numpy as np
import pytest

from tpu_inspect import oracle
from tpu_inspect.config import DefectParams, GridParams, SegmentationParams
from tpu_inspect.session import InspectionSession, SessionError
from tpu_inspect.synthetic import crop_units, make_mold_image

GRID = GridParams(
    base_unit=(20, 24, 64, 60), units_x=3, units_y=2, blocks_x=1, blocks_y=1,
    unit_space_x=10, unit_space_y=12,
)
HW = (220, 280)


def _session(defect_rate=0.8):
    sess = InspectionSession()
    ref = make_mold_image(GRID, HW, seed=1, defect_rate=defect_rate)
    cur = make_mold_image(GRID, HW, seed=2, defect_rate=defect_rate, shift=(4, -3))
    sess.add_image("ref.png", ref)
    sess.add_image("cur.png", cur)
    return sess, ref, cur


def test_first_image_is_reference():
    sess, *_ = _session()
    assert sess.reference_path == "ref.png"
    assert sess.current_path == "ref.png"
    assert sess.is_reference


def test_workflow_with_alignment_and_verdicts():
    sess, ref, cur = _session()
    assert sess.apply_indexing(GRID) == 6
    excl = {"shape": "rect", "x": 5, "y": 5, "w": 12, "h": 10}
    sess.add_exclusion(excl)
    seg_ref = sess.results().seg
    assert seg_ref is not None and len(sess.ref_centroids) == 6

    insp_ref = sess.set_inspection(True)
    assert insp_ref.verdicts.shape == (6,)

    # switching re-runs segmentation with alignment + inspection
    sess.switch_to("cur.png")
    assert not sess.is_reference
    seg_cur = sess.results().seg
    assert (seg_cur.shifts == np.array([4, -3])).all()

    # oracle cross-check on the current image
    crops = crop_units(cur, GRID)
    ref_masks, _, _ = oracle.segment_all_units(
        crops, sess.seg_params, exclusions=sess.exclusions,
        ref_centroids=sess.ref_centroids, is_reference=False,
    )
    np.testing.assert_array_equal(seg_cur.masks, ref_masks)
    _, ref_areas, ref_verd = oracle.inspect_units(crops, ref_masks, sess.defect_params)
    np.testing.assert_array_equal(sess.results().insp.verdicts, ref_verd)


def test_exclusion_editing_locked_off_reference():
    sess, *_ = _session()
    sess.apply_indexing(GRID)
    sess.run_segmentation()
    sess.switch_to("cur.png")
    with pytest.raises(SessionError, match="reference"):
        sess.add_exclusion({"shape": "rect", "x": 0, "y": 0, "w": 5, "h": 5})
    with pytest.raises(SessionError, match="reference"):
        sess.apply_indexing(GRID)


def test_size_mismatch_blocked():
    sess, *_ = _session()
    sess.apply_indexing(GRID)
    sess.run_segmentation()
    sess.add_image("small.png", np.zeros((100, 120), np.uint8))
    with pytest.raises(SessionError, match="size mismatch"):
        sess.switch_to("small.png")


def test_grid_export_import_round_trip(tmp_path):
    sess, *_ = _session()
    sess.apply_indexing(GRID)
    sess.add_exclusion({"shape": "circle", "cx": 30, "cy": 30, "r": 8})
    sess.run_segmentation()
    path = tmp_path / "g.json"
    sess.export_grid(path)

    sess2 = InspectionSession()
    sess2.add_image("ref.png", sess.image)
    n = sess2.import_grid(path)
    assert n == 6
    assert sess2.grid == GRID
    assert sess2.exclusions == sess.exclusions
    assert sess2.ref_centroids == sess.ref_centroids


def test_cli_end_to_end(tmp_path):
    import cv2

    from tpu_inspect import cli

    ref = make_mold_image(GRID, HW, seed=5, defect_rate=1.0)
    cur = make_mold_image(GRID, HW, seed=6, defect_rate=0.0, shift=(2, 1))
    ref_p, cur_p = str(tmp_path / "ref.png"), str(tmp_path / "cur.png")
    cv2.imwrite(ref_p, ref)
    cv2.imwrite(cur_p, cur)

    grid_p = str(tmp_path / "grid.json")
    cli.main([
        "gridgen", "--base", "20,24,64,60", "--units", "3x2", "--blocks", "1x1",
        "--unit-space", "10,12", "--block-space", "0,0",
        "--image-size", "280x220", "--out", grid_p,
    ])
    assert json.load(open(grid_p))["metadata"]["units_x"] == 3

    out_dir = str(tmp_path / "out")
    cli.main([
        "inspect", "--grid", grid_p, "--image", ref_p, cur_p,
        "--out", out_dir, "--min-area", "10",
    ])
    report = json.load(open(os.path.join(out_dir, "inspection.json")))
    assert set(report) == {ref_p, cur_p}
    assert report[ref_p]["unit_count"] == 6
    assert report[ref_p]["ng_count"] >= 1  # defect_rate 1.0
    assert report[cur_p]["ng_count"] == 0  # clean capture
    # per-image masks + CSV exported
    assert os.path.exists(os.path.join(out_dir, "ref", "masks_summary.csv"))
    assert os.path.exists(os.path.join(out_dir, "ref", "mask_0000.png"))


def test_run_inspection_reuses_cached_seg_masks(monkeypatch):
    """run_inspection must reuse the stored segmentation masks (even stale
    ones after a seg-param change), matching indexing_ui.py:1641-1662."""
    import tpu_inspect.engine as engine_mod

    sess, ref, cur = _session()
    sess.apply_indexing(GRID)
    sess.run_segmentation()
    old_masks = sess.results().seg.masks.copy()

    calls = {"n": 0}
    orig = engine_mod.inspect_image

    def counted(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(engine_mod, "inspect_image", counted)
    insp = sess.run_inspection()
    assert calls["n"] == 0  # no re-segmentation happened
    np.testing.assert_array_equal(sess.results().seg.masks, old_masks)

    # stale-mask semantics: change seg params, inspect again -> same masks
    sess.set_seg_params(SegmentationParams(gaussian_blur=7, morph_kernel=5))
    insp2 = sess.run_inspection()
    assert calls["n"] == 0
    np.testing.assert_array_equal(sess.results().seg.masks, old_masks)
    crops = np.asarray(crop_units(ref, GRID))
    _, o_areas, o_verd = oracle.inspect_units(crops, old_masks, sess.defect_params)
    np.testing.assert_array_equal(insp2.areas, o_areas)
    np.testing.assert_array_equal(insp2.verdicts, o_verd)


def test_param_change_exits_inspection():
    """Any parameter change exits inspection mode back to overlays
    (indexing_ui.py:1305-1316)."""
    sess, *_ = _session()
    sess.apply_indexing(GRID)
    sess.set_inspection(True)
    assert sess.inspection_enabled
    sess.set_defect_params(DefectParams(threshold=30))
    assert not sess.inspection_enabled
    assert sess.overlay_mode == "Both"
    sess.set_inspection(True)
    sess.set_seg_params(SegmentationParams(gaussian_blur=5))
    assert not sess.inspection_enabled


def test_test_defect_unit_matches_oracle():
    """Single-unit 'Test Defect Detection' (indexing_ui.py:1411-1469)."""
    sess, ref, cur = _session()
    sess.apply_indexing(GRID)
    sess.run_segmentation()
    sess.set_inspection(True)
    res = sess.test_defect_unit(2)
    assert not sess.inspection_enabled  # testing exits inspection
    assert sess.overlay_mode == "Both"
    crops = np.asarray(crop_units(ref, GRID))
    masks = sess.results().seg.masks
    dm = oracle.detect_defects(crops[2], masks[2], sess.defect_params)
    if dm is None:
        assert res["mask"] is None and res["area"] == 0
        assert res["verdict"] == "OK"
    else:
        np.testing.assert_array_equal(res["mask"], dm)
        assert res["area"] == int((dm > 0).sum())
    assert any("Unit 2: defect area=" in line for line in sess.log.tail())
    # the per-unit result landed in the cached inspection arrays
    assert sess.results().insp.areas[2] == res["area"]


def test_auto_update_defect_unit():
    """Debounced live re-run body (indexing_ui.py:1324-1339)."""
    sess, ref, cur = _session()
    sess.apply_indexing(GRID)
    sess.run_inspection()
    before = sess.results().insp.defect_masks[1].copy()
    sess.set_defect_params(DefectParams(threshold=200, min_area=1, erode_px=1))
    mask = sess.auto_update_defect_unit(1)
    crops = np.asarray(crop_units(ref, GRID))
    dm = oracle.detect_defects(
        crops[1], sess.results().seg.masks[1], sess.defect_params
    )
    if dm is None:
        assert mask is None
    else:
        np.testing.assert_array_equal(mask, dm)
    # other units untouched
    if dm is None or not np.array_equal(before, dm):
        pass  # value may change; only unit 1 was recomputed


def test_switch_back_keeps_cached_inspection():
    """Defect/inspection results are cached per image and survive a
    switch-away/switch-back without recompute (indexing_ui.py:1061-1085);
    segmentation is re-run on every switch (:1276-1280)."""
    sess, ref, cur = _session()
    sess.apply_indexing(GRID)
    sess.run_inspection()
    ref_insp = sess.results().insp
    sess.switch_to("cur.png")
    assert sess.results("ref.png").insp is ref_insp
    sess.switch_to("ref.png")
    assert sess.results().insp is ref_insp  # restored, not recomputed


def test_bare_list_grid_session_inspects_all_units():
    """Importing a legacy bare-list grid keeps every unit (advisor fix)."""
    from tpu_inspect.geometry import BoxGrid, grid_boxes as gb

    sess, ref, cur = _session()
    boxes = gb(GRID)
    data = [
        {"index": i, "x": x, "y": y, "w": w, "h": h}
        for i, (x, y, w, h) in enumerate(boxes)
    ]
    assert sess.import_grid(data) == 6
    assert isinstance(sess.grid, BoxGrid)
    seg = sess.run_segmentation()
    assert seg.masks.shape[0] == 6
    insp = sess.run_inspection()
    assert insp.verdicts.shape == (6,)
    # parity vs oracle over the same explicit boxes
    crops = np.asarray(crop_units(ref, GRID))
    o_masks, _, _ = oracle.segment_all_units(crops, sess.seg_params)
    np.testing.assert_array_equal(seg.masks, o_masks)


def test_cli_doctor(capsys):
    from tpu_inspect.cli import main

    main(["doctor"])
    out = capsys.readouterr().out
    import jax

    dev = jax.devices()[0]
    assert f"platform: {dev.platform}" in out
    assert f"device_kind: {dev.device_kind}" in out
    assert f"device count: {len(jax.devices())}" in out
    assert f"compile cache: {jax.config.jax_compilation_cache_dir}" in out
    assert "native io:" in out


def test_cli_stream(tmp_path, capsys):
    """`stream` subcommand: JSONL verdict line per frame, anchors from the
    first frame when the grid carries exclusions but no anchors."""
    import cv2

    from tpu_inspect import cli, engine, oracle
    from tpu_inspect.config import DefectParams, SegmentationParams
    from tpu_inspect.persistence import GridDocument, grid_metadata, save_grid
    from tpu_inspect.geometry import grid_boxes
    from tpu_inspect.synthetic import crop_units

    frames = [
        make_mold_image(GRID, HW, seed=20 + s, defect_rate=0.8) for s in range(3)
    ]
    paths = []
    for i, f in enumerate(frames):
        p = str(tmp_path / f"cap_{i}.png")
        assert cv2.imwrite(p, f)
        paths.append(p)
    excl = [{"shape": "rect", "x": 4, "y": 4, "w": 9, "h": 9}]
    grid_p = str(tmp_path / "grid.json")
    save_grid(
        GridDocument(boxes=grid_boxes(GRID), metadata=grid_metadata(GRID, *HW[::-1]),
                     exclusions=excl),
        grid_p,
    )

    cli.main(["stream", "--grid", grid_p, *paths, "--min-area", "5"])
    lines = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert [l["index"] for l in lines] == [0, 1, 2]
    assert all(l["unit_count"] == 6 for l in lines)

    # oracle cross-check: first frame anchors, streaming verdicts per frame
    seg, dfp = SegmentationParams(), DefectParams(min_area=5)
    anchors = engine.segment_units(crop_units(frames[0], GRID), seg).centroid_dict()
    for i, line in enumerate(lines):
        crops = crop_units(frames[i], GRID)
        masks, _, _ = oracle.segment_all_units(
            crops, seg, exclusions=excl, ref_centroids=anchors,
            is_reference=False)
        _, _, verdicts = oracle.inspect_units(crops, masks, dfp)
        assert line["ng_count"] == int(verdicts.sum())
        assert line["ng_units"] == [int(x) for x in np.nonzero(verdicts)[0]]


def test_verbose_defect_diagnostics_log_formats():
    """Single-unit verbose debug channel: the reference's per-stage log
    lines in their exact formats (indexing_ui.py:1494, :1535, :1549), with
    values matching the oracle's own intermediates."""
    import re

    import cv2

    sess, ref, cur = _session()
    sess.apply_indexing(GRID)
    sess.run_segmentation()
    idx = 2
    sess.test_defect_unit(idx, verbose=True)
    lines = list(sess.log.tail())

    # oracle-side intermediates (the reference's own chain)
    crops = np.asarray(crop_units(ref, GRID))
    masks = sess.results().seg.masks
    p = sess.defect_params
    seg_area0 = int((masks[idx] > 0).sum())
    assert f"Seg mask area (roi)={seg_area0}, erode_px={p.erode_px}" in lines
    seg_bin = ((masks[idx] > 0).astype(np.uint8)) * 255
    if p.erode_px > 0:
        seg_bin = cv2.erode(seg_bin, None, iterations=int(p.erode_px))
    nlab, labels, stats, _ = cv2.connectedComponentsWithStats(
        (seg_bin > 0).astype(np.uint8), connectivity=8
    )
    if nlab > 1:
        best = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
        seg_bin = (labels == best).astype(np.uint8) * 255
    if seg_bin.sum() == 0:
        assert any("Segmentation mask empty after erode" in l for l in lines)
        return
    roi_area = int((seg_bin > 0).sum())
    bg = cv2.medianBlur(crops[idx], 21)
    resid = cv2.absdiff(crops[idx], bg)
    _, cand = cv2.threshold(resid, int(p.threshold), 255, cv2.THRESH_BINARY)
    cand = cv2.bitwise_and(cand, seg_bin)
    cand = cv2.morphologyEx(
        cand, cv2.MORPH_OPEN,
        cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3)), iterations=1,
    )
    assert f"Residual mask area={int((cand > 0).sum())}" in lines
    max_area = max(int(p.min_area), int(roi_area * 0.98))
    assert (
        f"Defect area filter: min={p.min_area}, max={max_area}, "
        f"seg_area={roi_area}" in lines
    )
    # skip-large lines match the oracle's contour filter decisions
    cnts, _ = cv2.findContours(
        cand.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE
    )
    expect = sorted(
        int(cv2.contourArea(c))
        for c in cnts
        if cv2.contourArea(c) >= p.min_area and cv2.contourArea(c) > max_area
    )
    got = sorted(
        int(m.group(1))
        for l in lines
        if (m := re.match(r"Skipping large contour area=(\d+) ", l))
    )
    assert got == expect
