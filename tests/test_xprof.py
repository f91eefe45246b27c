"""Trace reduction of tpu_inspect.utils.xprof (the `cli profile` command).

Reads a real jax.profiler trace taken on the test platform, maps a
compiled step's HLO op names to the engine's named scopes, and reduces
hand-made device events to busy time, idle gaps and per-stage totals.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tpu_inspect.utils import xprof


@pytest.fixture(scope="module")
def trace_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("trace"))
    x = jnp.asarray(np.random.RandomState(0).rand(256, 256).astype(np.float32))
    f = jax.jit(lambda a: (a @ a).sum())
    float(f(x))  # compile outside the trace
    with jax.profiler.trace(d):
        for _ in range(3):
            float(f(x))
    if not xprof.find_xplane_files(d):
        pytest.skip("platform produced no xplane trace")
    return d


def test_reads_host_plane_events(trace_dir):
    evs = xprof.trace_events(trace_dir, plane="/host:", line="")
    assert evs, "no events read from a real trace"
    assert all(isinstance(name, str) and name for name, _, _, _ in evs)
    assert all(dur >= 0 for _, _, _, dur in evs)
    assert any(dur > 0 for _, _, _, dur in evs)


def test_device_query(trace_dir):
    # the first GPU's stream lines: none on the CPU, kernels on a GPU
    evs = xprof.trace_events(trace_dir)
    if jax.devices()[0].platform == "cpu":
        assert evs == []
    else:
        assert evs and xprof.busy_ns(evs)[0] > 0


def test_no_trace_reads_empty(tmp_path):
    assert xprof.find_xplane_files(str(tmp_path)) == []
    assert xprof.trace_events(str(tmp_path)) == []


def test_hlo_names_map_to_engine_scopes():
    from tpu_inspect import engine
    from tpu_inspect.config import DefectParams, GridParams, SegmentationParams
    from tpu_inspect.geometry import grid_origins
    from tpu_inspect.synthetic import make_mold_image

    g = GridParams(base_unit=(4, 4, 40, 36), units_x=2)
    img = make_mold_image(g, (48, 96), seed=1)
    args = (
        jnp.asarray(img), jnp.asarray(grid_origins(g)),
        jnp.asarray([[2, 2, 5, 4]], jnp.int32), jnp.zeros((0, 3), jnp.int32),
        jnp.zeros((2, 2)), jnp.zeros((2,), bool),
    )
    kw = dict(
        seg=SegmentationParams().validated(),
        defect=DefectParams().validated(), is_reference=True,
        unit_hw=(36, 40), with_defects=True,
    )
    compiled = engine._inspect_image_device.lower(*args, **kw).compile()
    names = xprof.hlo_op_names(compiled.as_text())
    stages = {xprof.stage_of(op) for op in names.values()}
    for scope in ("gather", "gauss", "thresh", "morph", "holefill",
                  "seg_centroid", "exclusions", "roi_erode", "roi_largest",
                  "median_residual", "blob_filter"):
        assert scope in stages, scope
    # the profiled executable is the program the engine runs
    jax.tree.map(np.testing.assert_array_equal, compiled(*args),
                 engine._inspect_image_device(*args, **kw))


@pytest.mark.parametrize("op, stage", [
    ("jit(f)/defect_roi/roi_largest/while/body/min", "roi_largest"),
    ("jit(f)/blob_filter/cand_open/reduce", "cand_open"),
    ("jit(f)/broadcast", "other"),
])
def test_stage_is_innermost_scope(op, stage):
    assert xprof.stage_of(op) == stage


def test_busy_time_and_idle_gaps():
    evs = [  # (kernel, hlo op, start ns, duration ns)
        ("a", "", 0.0, 100e3),
        ("b", "", 50e3, 100e3),   # overlaps a
        ("c", "", 200e3, 20e3),   # 50 us gap after b
        ("d", "", 225e3, 10e3),   # 5 us gap: below the threshold
    ]
    busy, window = xprof.busy_ns(evs)
    assert (busy, window) == (180e3, 235e3)
    gaps = xprof.idle_gaps(evs)
    assert len(gaps) == 1
    np.testing.assert_allclose(gaps[0][0], 50e3)
    assert gaps[0][1:] == ("b", "c")


def test_no_events_reduce_to_nothing():
    assert xprof.busy_ns([]) == (0.0, 0.0)
    assert xprof.idle_gaps([]) == []
    assert xprof.stage_totals([], {}) == ({}, {}, 0)


def test_stage_totals():
    names = {
        "fusion.3": "jit(f)/defect_roi/roi_largest/while/body/min",
        "loop_reduce_fusion_1": "jit(f)/median_residual/scan/add",
    }
    evs = [  # kernels map by their hlo_op stat, else by their own name
        ("loop_fusion", "fusion.3", 0.0, 10.0),
        ("loop_fusion", "fusion.3", 20.0, 30.0),
        ("loop_reduce_fusion_1", "", 60.0, 5.0),
        ("memcpy", "", 70.0, 1.0),
    ]
    by_stage, by_kernel, unmapped = xprof.stage_totals(evs, names)
    assert by_stage == {"roi_largest": [40.0, 2],
                        "median_residual": [5.0, 1], "other": [1.0, 1]}
    assert by_kernel["loop_fusion [roi_largest]"] == [40.0, 2]
    assert unmapped == 1
