"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its phases
(one-card and four-card) agree with the oracle at a small size."""

import functools
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tools"))

import chip_smoke  # noqa: E402
import make_golden  # noqa: E402


def test_exits_nonzero_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300,
    )
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


@pytest.fixture
def small_workload(monkeypatch):
    """A 4-unit grid on a 120x160 image in place of the full-size inputs."""
    from tpu_inspect.config import GridParams
    from tpu_inspect.engine import pack_exclusions
    from tpu_inspect.geometry import grid_origins
    from tpu_inspect.synthetic import make_mold_image

    grid = GridParams(base_unit=(6, 8, 60, 48), units_x=2, units_y=2,
                      unit_space_x=10, unit_space_y=8)
    hw = (120, 160)
    exclusions = [{"shape": "circle", "cx": 12, "cy": 12, "r": 5}]
    rects, circles = pack_exclusions(exclusions)
    u = grid.num_units
    wl = {
        "grid": grid,
        "image": make_mold_image(grid, hw, seed=0, defect_rate=0.5),
        "origins": grid_origins(grid),
        "exclusions": exclusions,
        "rects": rects,
        "circles": circles,
        "ref_centroids": np.zeros((u, 2), np.float64),
        "ref_valid": np.zeros((u,), bool),
        "unit_hw": (48, 60),
    }
    monkeypatch.setattr(make_golden, "workload", lambda: wl)
    monkeypatch.setattr(
        make_golden, "shifted_image",
        functools.lru_cache(None)(lambda: make_mold_image(
            grid, hw, seed=0, defect_rate=0.5, shift=(3, -2))),
    )
    monkeypatch.setattr(
        make_golden, "stream_frames",
        functools.lru_cache(None)(lambda: tuple(
            make_mold_image(grid, hw, seed=s, defect_rate=0.5)
            for s in (1, 2, 3, 4))),
    )
    return wl


def test_single_card_phases_small(small_workload, capsys):
    chip_smoke.run_single(runs=1, expect=make_golden.oracle_record,
                          analyse_memory=False)
    out = capsys.readouterr().out
    for case in make_golden.CASES:
        assert f"[{case}] parity: exact" in out


def test_multi_card_phases_small(small_workload, capsys):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    chip_smoke.run_multi(devices, runs=1)
    out = capsys.readouterr().out
    for name in ("unit_mesh_reference", "unit_mesh_shifted",
                 "image_unit_batch", "stream_sharded", "strip_mesh_4"):
        assert f"[{name}] parity: exact" in out


def test_parity_mismatch_names_the_field():
    a = make_golden.record(np.zeros((2, 2), np.uint8), np.zeros((1, 2, 2)),
                           np.zeros((1, 2, 2)), [True], [3], [True])
    b = json.loads(json.dumps(a))
    b["areas"] = [4]
    with pytest.raises(chip_smoke.ParityError, match="areas"):
        chip_smoke.check("case", a, b)
    chip_smoke.check("case", a, json.loads(json.dumps(a)))
