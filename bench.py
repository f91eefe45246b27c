"""Benchmark: full-grid 4096x3000 segmentation + defect + verdicts.

Prints ONE JSON line:
  {"metric": ..., "value": <device ms/image>, "unit": "ms", "vs_baseline": <speedup>}

- Device path: the fused single-roundtrip pipeline (tpu_inspect.engine
  ._inspect_image_device) on the reference sample workload (48 units of
  316x315 on a 4096x3000 mold image), steady-state median over N runs with
  the image device-resident and verdicts read back each run.
- Baseline: the reference's per-unit OpenCV chain (tpu_inspect.oracle) on
  one CPU core (cv2.setNumThreads(1)) — the exact call sequence of
  run_segmentation_all + run_inspection (indexing_ui.py:2203-2368,
  :1634-1709).

Extra diagnostics go to stderr; stdout carries only the JSON line.
"""

import json
import sys
import time

import numpy as np


def _emit(
    metric: str,
    value_ms,
    cpu_ms: float,
    error: str | None = None,
    samples=None,
):
    """Print THE one JSON line. Failed runs report value null (legal JSON)
    plus an error string, never Infinity/NaN. ``samples`` (the raw per-run
    ms measurements) adds min/max/n spread fields; ``value`` stays the
    tracked median."""
    rec = {"metric": metric, "unit": "ms"}
    if value_ms is None or not (value_ms == value_ms) or value_ms in (
        float("inf"),
        float("-inf"),
    ):
        rec["value"] = None
        rec["vs_baseline"] = 0.0
        rec["error"] = error or "parity gate failed"
    else:
        rec["value"] = round(float(value_ms), 3)
        rec["vs_baseline"] = (
            round(cpu_ms / value_ms, 2) if value_ms > 0 else 0.0
        )
        if samples:
            rec["min"] = round(float(min(samples)), 3)
            rec["max"] = round(float(max(samples)), 3)
            rec["n"] = len(samples)
        if error:
            rec["error"] = error
    print(json.dumps(rec))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _run_child(tag: str):
    """Run ``bench.py <tag>-child`` in a subprocess and relay its JSON
    line(s). The parent never imports jax, so the child is the only process
    that holds the card."""
    import subprocess

    p = subprocess.run(
        [sys.executable, __file__, tag + "-child"],
        stdout=subprocess.PIPE,
        stderr=sys.stderr,
    )
    for ln in p.stdout.decode().strip().splitlines():
        print(ln)
    sys.exit(p.returncode)


def main_config1(with_defects: bool = False):
    """BASELINE config 1: one whole-image 4096x3000 crop through the
    segmentation chain, `python bench.py config1`. With `config1defect` the
    defect chain (21x21 median residual + blob filter + verdict) runs on the
    same whole-image unit too."""
    import cv2

    import jax
    import jax.numpy as jnp

    from tpu_inspect.config import DefectParams, SegmentationParams
    from tpu_inspect.engine import _defect_device, raw_segment
    from tpu_inspect import oracle
    from tpu_inspect.synthetic import standard_workload

    metric = (
        "single_unit_4096x3000_seg_defect_ms"
        if with_defects
        else "single_unit_4096x3000_segmentation_ms"
    )
    image = standard_workload()["image"]
    seg = SegmentationParams().validated()
    defect = DefectParams().validated()

    cv2.setNumThreads(1)
    t0 = time.perf_counter()
    ref = oracle.segment_unit(image, seg)
    ref_areas = ref_verdicts = None
    if with_defects:
        _, ref_areas, ref_verdicts = oracle.inspect_units(
            image[None], ref[None], defect
        )
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    log(f"CPU baseline (1 core, OpenCV chain): {cpu_ms:.1f} ms")

    def step(a):
        m = raw_segment(a, seg)
        if not with_defects:
            return m, None
        _, found, area, verdict = _defect_device(a, m, params=defect)
        return m, (found, area, verdict)

    x = jnp.asarray(image)[None]
    f = jax.jit(step)
    t0 = time.perf_counter()
    out = jax.block_until_ready(f(x))
    log(f"compile+first: {time.perf_counter() - t0:.1f} s on {jax.devices()[0]}")
    parity = bool((np.asarray(out[0][0]) == ref).all())
    if with_defects:
        _, area, verdict = (np.asarray(v) for v in out[1])
        parity = parity and bool(
            (area == ref_areas).all() and (verdict == ref_verdicts).all()
        )
        log(f"defect: area={int(area[0])} NG={bool(verdict[0])}")
    log(f"parity: exact={parity}")

    # N chained passes per dispatch amortize the per-dispatch overhead
    N = 16

    def chained(a):
        def body(i, c):
            m, extra = step(c[0])
            acc = m.sum(dtype=jnp.int32)
            if extra is not None:
                acc = acc + extra[1].sum(dtype=jnp.int32)
            bump = (acc & 1).astype(jnp.uint8)
            return c[0] ^ bump, c[1] + acc

        return jax.lax.fori_loop(0, N, body, (a, jnp.int32(0)))[1]

    fc = jax.jit(chained)
    t0 = time.perf_counter()
    int(np.asarray(fc(x)))
    log(f"chained-{N} compile+first: {time.perf_counter() - t0:.1f} s")
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        int(np.asarray(fc(x)))
        times.append((time.perf_counter() - t0) * 1000.0 / N)
    dev_ms = float(np.median(times))
    log(f"device steady-state: {dev_ms:.2f} ms (min {min(times):.2f})")
    _emit(metric, dev_ms if parity else None, cpu_ms, samples=times)


def main_stream():
    """BASELINE config 5: steady-state streaming throughput.

    Feeds N distinct synthetic frames through streaming.stream_inspect
    (pipelined dispatch, verdicts fetched per frame) and reports wall-clock
    ms/frame after warmup. Includes host->device transfer and dispatch —
    the number a production camera loop sees (device time per image is the
    main bench's chained metric)."""
    import cv2

    from tpu_inspect.config import DefectParams, SegmentationParams
    from tpu_inspect import oracle
    from tpu_inspect.streaming import stream_inspect
    from tpu_inspect.synthetic import (
        crop_units,
        make_mold_image,
        standard_workload,
    )

    metric = "stream_4096x3000_wall_ms_per_frame"
    wl = standard_workload()
    grid = wl["grid"]
    seg = SegmentationParams().validated()
    defect = DefectParams().validated()
    n_warm, n_meas = 4, 12
    frames = [wl["image"]] + [
        make_mold_image(grid, (3000, 4096), seed=s, defect_rate=0.3)
        for s in range(1, n_warm + n_meas)
    ]

    # CPU baseline: one frame through the reference chain
    cv2.setNumThreads(1)
    crops = crop_units(frames[0], grid)
    t0 = time.perf_counter()
    masks, _, _ = oracle.segment_all_units(
        crops, seg, exclusions=wl["exclusions"]
    )
    _, ref_areas, ref_verdicts = oracle.inspect_units(crops, masks, defect)
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    log(f"CPU baseline (1 core, OpenCV): {cpu_ms:.1f} ms/frame")

    results = []
    frame_times = []  # per-frame wall ms after warmup (spread for _emit)
    t_prev = None
    stream = stream_inspect(
        frames, grid, seg, defect, exclusions=wl["exclusions"], prefetch=2
    )
    for i, res in enumerate(stream):
        results.append(res)
        if i >= n_warm - 1:
            now = time.perf_counter()
            if t_prev is not None:
                frame_times.append((now - t_prev) * 1000.0)
            t_prev = now
    wall_ms = float(np.median(frame_times))
    parity = bool(
        (results[0].verdicts == ref_verdicts).all()
        and (results[0].areas == ref_areas).all()
    )
    log(
        f"stream: {len(results)} frames, {wall_ms:.2f} ms/frame wall median "
        f"(min {min(frame_times):.2f}, max {max(frame_times):.2f}; "
        f"parity on frame 0: {parity})"
    )

    # Device-bound per-frame metric: F distinct frames are made device-
    # resident ONCE and the full per-frame inspection loop is chained on
    # device cycling through them — the stream loop's device work with the
    # host->device transfer removed.
    import jax
    import jax.numpy as jnp

    from tpu_inspect.engine import _inspect_image_device

    F, N = 4, 64
    stack = jnp.asarray(np.stack([np.asarray(f) for f in frames[:F]]))
    args_rest = (
        jnp.asarray(wl["origins"]),
        jnp.asarray(wl["rects"]),
        jnp.asarray(wl["circles"]),
        jnp.asarray(wl["ref_centroids"]),
        jnp.asarray(wl["ref_valid"]),
    )
    kw = dict(
        seg=seg,
        defect=defect,
        is_reference=True,
        unit_hw=wl["unit_hw"],
        with_defects=True,
    )

    def chained_frames(fr):
        def body(i, carry):
            fr_c, acc = carry
            img = jax.lax.dynamic_index_in_dim(
                fr_c, i % F, axis=0, keepdims=False
            )
            o = _inspect_image_device(img, *args_rest, **kw)
            v, a = o[4][3], o[4][2]
            bump = (a.sum(dtype=jnp.int32) & 1).astype(jnp.uint8)
            return fr_c ^ bump, acc + v.sum(dtype=jnp.int32)

        return jax.lax.fori_loop(0, N, body, (fr, jnp.int32(0)))[1]

    fc = jax.jit(chained_frames)
    t0 = time.perf_counter()
    int(np.asarray(fc(stack)))
    log(f"device chained-{N} (x{F} frames) compile+first: "
        f"{time.perf_counter() - t0:.1f} s")
    dev_times = []
    for _ in range(4):
        t0 = time.perf_counter()
        int(np.asarray(fc(stack)))
        dev_times.append((time.perf_counter() - t0) * 1000.0 / N)
    dev_ms = float(np.median(dev_times))
    log(f"stream device: {dev_ms:.2f} ms/frame (chained x{N} over "
        f"{F} resident frames, min {min(dev_times):.2f})")
    _emit(
        "stream_4096x3000_device_ms_per_frame",
        dev_ms if parity else None,
        cpu_ms,
        samples=dev_times,
    )
    _emit(metric, wall_ms if parity else None, cpu_ms, samples=frame_times)


def _method_combo_parity(crops) -> bool:
    """Parity gate across all four seg x defect method combos.

    The main gate runs otsu + threshold (the defaults); a device-lowering
    regression in adaptiveThreshold (segmentation.py:83-89) or Canny
    (indexing_ui.py:1536-1539) would otherwise ship green. One 16-unit
    subset run per remaining combo keeps the cost to a few extra compiles.
    """
    import numpy as np

    from tpu_inspect import engine, oracle
    from tpu_inspect.config import DefectParams, SegmentationParams

    sub = np.asarray(crops[:16])
    ok = True
    for seg_m in ("otsu", "adaptive"):
        seg_p = SegmentationParams(method=seg_m).validated()
        ref_masks, _, _ = oracle.segment_all_units(sub, seg_p)
        got = engine.segment_units(sub, seg_p).masks
        seg_ok = bool((got == ref_masks).all())
        ok &= seg_ok
        for def_m in ("threshold", "canny"):
            if seg_m == "otsu" and def_m == "threshold":
                continue  # the main full-grid gate covers the defaults
            def_p = DefectParams(method=def_m).validated()
            _, ref_areas, ref_verd = oracle.inspect_units(
                sub, ref_masks, def_p
            )
            insp = engine.detect_defects_batch(sub, ref_masks, def_p)
            combo_ok = bool(
                (insp.areas == ref_areas).all()
                and (insp.verdicts == ref_verd).all()
            )
            ok &= combo_ok
            log(f"parity[{seg_m}/{def_m}]: seg={seg_ok} defect={combo_ok}")
    return ok


def main():
    import cv2

    import jax
    import jax.numpy as jnp

    from tpu_inspect.config import DefectParams, SegmentationParams
    from tpu_inspect.engine import _inspect_image_device
    from tpu_inspect import oracle
    from tpu_inspect.synthetic import crop_units, standard_workload

    wl = standard_workload()
    grid, image, origins = wl["grid"], wl["image"], wl["origins"]
    u = origins.shape[0]
    exclusions = wl["exclusions"]
    rects, circles = wl["rects"], wl["circles"]
    seg = SegmentationParams().validated()
    defect = DefectParams().validated()

    # ---- CPU baseline (1 core, OpenCV chain) ----
    cv2.setNumThreads(1)
    crops = crop_units(image, grid)
    t0 = time.perf_counter()
    ref_masks, _, _ = oracle.segment_all_units(crops, seg, exclusions=exclusions)
    _, ref_areas, ref_verdicts = oracle.inspect_units(crops, ref_masks, defect)
    cpu_ms = (time.perf_counter() - t0) * 1000.0
    log(f"CPU baseline (1 core, OpenCV): {cpu_ms:.1f} ms/image")

    # ---- device fused pipeline ----
    dev_image = jnp.asarray(image)
    args = (
        dev_image,
        jnp.asarray(origins),
        jnp.asarray(rects),
        jnp.asarray(circles),
        jnp.asarray(wl["ref_centroids"]),
        jnp.asarray(wl["ref_valid"]),
    )
    kw = dict(
        seg=seg,
        defect=defect,
        is_reference=True,
        unit_hw=wl["unit_hw"],
        with_defects=True,
    )

    t0 = time.perf_counter()
    out = jax.block_until_ready(_inspect_image_device(*args, **kw))
    log(f"compile+first run: {time.perf_counter() - t0:.1f} s on {jax.devices()[0]}")

    # correctness gate: the benchmark only counts if parity holds
    masks = np.asarray(out[0])
    verdicts = np.asarray(out[4][3])
    areas = np.asarray(out[4][2])
    iou_exact = bool((masks == ref_masks).all())
    verdict_ok = bool((verdicts == ref_verdicts).all() and (areas == ref_areas).all())
    log(f"parity: masks_exact={iou_exact} verdicts_exact={verdict_ok} "
        f"NG={int(verdicts.sum())}/{u}")
    combos_ok = _method_combo_parity(crops)
    verdict_ok = verdict_ok and combos_ok
    log(f"parity: otsu/adaptive x threshold/canny all exact = {combos_ok}")

    # single-call latency (includes host<->device dispatch overhead;
    # reported to stderr for reference)
    t0 = time.perf_counter()
    jax.block_until_ready(_inspect_image_device(*args, **kw))
    single_ms = (time.perf_counter() - t0) * 1000.0
    log(f"single-call latency (incl. dispatch): {single_ms:.1f} ms")

    # steady-state device throughput: N passes chained on device in one
    # dispatch (each pass data-depends on the previous so XLA cannot hoist),
    # with the verdicts fetched at the end — the per-image time of a
    # production streaming pipeline. N amortizes the per-dispatch overhead.
    N = 512

    def chained(img):
        def body(i, carry):
            img_c, acc = carry
            o = _inspect_image_device(img_c, *args[1:], **kw)
            v, a = o[4][3], o[4][2]
            # genuine data dependence (NOT provably zero, so XLA cannot
            # hoist the pipeline out of the loop): xor the image's LSBs
            # with the parity of the defect areas
            bump = (a.sum(dtype=jnp.int32) & 1).astype(jnp.uint8)
            return img_c ^ bump, acc + v.sum(dtype=jnp.int32)
        _, acc = jax.lax.fori_loop(0, N, body, (img, jnp.int32(0)))
        return acc

    fc = jax.jit(chained)
    t0 = time.perf_counter()
    int(np.asarray(fc(dev_image)))
    log(f"chained-{N} compile+first: {time.perf_counter() - t0:.1f} s")
    times = []
    for _ in range(4):
        t0 = time.perf_counter()
        int(np.asarray(fc(dev_image)))
        times.append((time.perf_counter() - t0) * 1000.0 / N)
    dev_ms = float(np.median(times))
    log(f"device steady-state: {dev_ms:.2f} ms/image (chained x{N}, "
        f"min {min(times):.2f})")

    _emit(
        "full_grid_4096x3000_seg_defect_ms_per_image",
        dev_ms if (iou_exact and verdict_ok) else None,
        cpu_ms,
        samples=times,
    )


if __name__ == "__main__":
    arg = sys.argv[1] if len(sys.argv) > 1 else ""
    if arg == "config1":
        _run_child("config1")
    elif arg == "config1-child":
        main_config1()
    elif arg == "config1defect":
        _run_child("config1defect")
    elif arg == "config1defect-child":
        main_config1(with_defects=True)
    elif arg == "stream":
        main_stream()
    elif arg == "main-child":
        main()
    else:
        _run_child("main")
