"""Smoke run of the inspection pipeline on one NVIDIA GPU.

Drives the main path through its public entry points at full size, in one
process, and compares every phase bit for bit (masks, areas, verdicts,
anchors, shifts) with the OpenCV oracle: live when ``cv2`` imports,
otherwise the committed record ``tests/data/golden_smoke.json`` that
``tools/make_golden.py`` writes from the same seeded inputs.

Phases (one card):

1. ``engine.inspect_image`` on the standard workload (48 units of 316x315
   on a 4096x3000 image, one circle exclusion, reference capture), for each
   of otsu/adaptive x threshold/canny;
2. a production capture shifted by (7, -4) with the anchors of phase 1
   (centroid alignment, per-unit exclusion zones);
3. whole-image segmentation and defect detection on one 4096x3000 unit;
4. ``streaming.stream_inspect`` over 4 distinct frames.

``--multi`` runs only the multi-card paths on four cards, each against the
one-card result in the same process: the unit mesh, the image x unit mesh
(batch and stream), and the row-strip mesh at 3000x4096.

Per phase it prints parity, compile seconds (first call less a steady
call), steady-state wall ms and peak device memory, plus the XLA memory
analysis of the 48-unit step and the card's name and power limit. The last
line is one JSON object naming the device. Without a GPU it exits non-zero
and prints no result.

Usage: python chip_smoke.py [--multi]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tools"))

import make_golden as mg  # noqa: E402  (the cases and their records)

RUNS = 3  # steady-state calls per phase


class ParityError(AssertionError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def expectation():
    """case -> expected record: the live oracle if OpenCV imports, else the
    committed golden record."""
    try:
        import cv2
    except ImportError:
        log("reference: committed golden record (OpenCV not importable)")
        golden = mg.load_golden()
        return golden.__getitem__
    log(f"reference: live OpenCV oracle (cv2 {cv2.__version__})")
    return mg.oracle_record


def check(name: str, expected: dict, got: dict) -> None:
    bad = mg.diff(expected, got)
    if bad:
        log(f"[{name}] parity: MISMATCH at {', '.join(bad)}")
        raise ParityError(f"{name}: {bad}")
    log(f"[{name}] parity: exact")


def timed(fn, runs: int):
    """(result, first-call s, steady wall ms list). Every call ends in host
    arrays, so the clock covers the device work."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, first, times


def report(name: str, first: float, times: list, per: int = 1) -> None:
    import jax

    med = float(np.median(times)) / per
    compile_s = max(0.0, first - med * per / 1e3)
    peak = jax.devices()[0].memory_stats() or {}
    peak_gb = peak.get("peak_bytes_in_use", 0) / 2**30
    unit = "ms/frame" if per > 1 else "ms"
    log(
        f"[{name}] compile {compile_s:.2f} s (first call {first:.2f} s), "
        f"steady {med:.3f} {unit} (runs {', '.join(f'{t / per:.3f}' for t in times)}), "
        f"peak device memory {peak_gb:.3f} GiB"
    )


def _centroid_list(seg_res):
    return [
        c if ok else None
        for c, ok in zip(seg_res.centroids, seg_res.centroid_valid)
    ]


def memory_analysis(image, wl, seg, defect) -> None:
    """XLA's memory analysis of the compiled 48-unit step."""
    import jax.numpy as jnp

    from tpu_inspect import engine

    compiled = engine._inspect_image_device.lower(
        jnp.asarray(image),
        jnp.asarray(wl["origins"]),
        jnp.asarray(wl["rects"]),
        jnp.asarray(wl["circles"]),
        jnp.asarray(wl["ref_centroids"]),
        jnp.asarray(wl["ref_valid"]),
        seg=seg, defect=defect, is_reference=True,
        unit_hw=wl["unit_hw"], with_defects=True,
    ).compile()
    ma = compiled.memory_analysis()
    fields = (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes",
    )
    log("[units] memory_analysis: " + ", ".join(
        f"{f.replace('_size_in_bytes', '')} {getattr(ma, f, 0) / 2**20:.1f} MiB"
        for f in fields
    ))


def run_single(runs: int = RUNS, expect=None, analyse_memory: bool = True):
    """The one-card phases; raises ParityError on the first mismatch."""
    import jax
    import jax.numpy as jnp

    from tpu_inspect import engine, streaming

    expect = expect or expectation()
    wl = mg.workload()
    grid, image, excl = wl["grid"], wl["image"], wl["exclusions"]

    # 1. the 48-unit reference capture, every method combination
    anchors = None
    for seg_m, def_m in mg.COMBOS:
        name = f"units_{seg_m}_{def_m}"
        seg, defect = mg.params(seg_m, def_m)
        (sr, ir), first, times = timed(
            lambda: engine.inspect_image(
                image, grid, seg, defect, exclusions=excl, is_reference=True
            ),
            runs,
        )
        got = mg.record(image, sr.masks, ir.defect_masks, ir.valid,
                        ir.areas, ir.verdicts, centroids=_centroid_list(sr))
        check(name, expect(name), got)
        report(name, first, times)
        if (seg_m, def_m) == mg.COMBOS[0]:
            anchors = sr.centroid_dict()
            if analyse_memory:
                memory_analysis(image, wl, seg, defect)

    # 2. shifted production capture, aligned to the phase-1 anchors
    seg, defect = mg.params()
    shifted = mg.shifted_image()
    (sr, ir), first, times = timed(
        lambda: engine.inspect_image(
            shifted, grid, seg, defect, exclusions=excl,
            ref_centroids=anchors, is_reference=False,
        ),
        runs,
    )
    got = mg.record(shifted, sr.masks, ir.defect_masks, ir.valid, ir.areas,
                    ir.verdicts, shifts=sr.shifts)
    check("shifted", expect("shifted"), got)
    report("shifted", first, times)

    # 3. one whole-image unit: segmentation + defect chain
    def whole_step(a):
        m = engine.raw_segment(a, seg)
        return m, engine._defect_device(a, m, params=defect)

    step = jax.jit(whole_step)
    x = jnp.asarray(image)[None]
    (m, (dm, found, area, verdict)), first, times = timed(
        lambda: jax.tree.map(np.asarray, step(x)), runs
    )
    got = mg.record(image, m, dm, found, area, verdict)
    check("whole_image", expect("whole_image"), got)
    report("whole_image", first, times)

    # 4. streaming over distinct frames
    frames = mg.stream_frames()
    results, first, times = timed(
        lambda: list(streaming.stream_inspect(
            frames, grid, seg, defect, exclusions=excl, fetch_masks=True
        )),
        runs,
    )
    got = {"frames": [
        mg.record(f, r.seg_masks, r.defect_masks, r.valid, r.areas,
                  r.verdicts)
        for f, r in zip(frames, results)
    ]}
    check("stream", expect("stream"), got)
    report("stream", first, times, per=len(frames))


def run_multi(devices, runs: int = RUNS):
    """The multi-card paths on ``devices`` (four cards), each against the
    one-card result computed in this process."""
    import jax
    import jax.numpy as jnp

    from tpu_inspect import engine, streaming
    from tpu_inspect.parallel import (
        defect_image_sharded,
        image_unit_mesh,
        inspect_image_batch_sharded,
        inspect_units_sharded,
        segment_image_sharded,
        strip_mesh,
        unit_mesh,
    )
    from tpu_inspect.synthetic import crop_units

    wl = mg.workload()
    grid, image, excl = wl["grid"], wl["image"], wl["exclusions"]
    seg, defect = mg.params()
    n = len(devices)

    def units_record(img, sr, ir, shifts=False):
        return mg.record(
            img, sr.masks, ir.defect_masks, ir.valid, ir.areas, ir.verdicts,
            centroids=_centroid_list(sr),
            shifts=sr.shifts if shifts else None,
        )

    # unit mesh: reference capture, then the shifted capture aligned to it
    umesh = unit_mesh(devices)
    anchors = None
    for name, img, ref in (
        ("unit_mesh_reference", image, None),
        ("unit_mesh_shifted", mg.shifted_image(), "anchors"),
    ):
        crops = crop_units(img, grid)
        kw = dict(exclusions=excl, ref_centroids=anchors,
                  is_reference=ref is None)
        one = units_record(img, *engine.inspect_units(crops, seg, defect, **kw),
                           shifts=True)
        (sr, ir), first, times = timed(
            lambda: inspect_units_sharded(crops, seg, defect, mesh=umesh, **kw),
            runs,
        )
        check(name, one, units_record(img, sr, ir, shifts=True))
        report(name, first, times)
        if ref is None:
            anchors = sr.centroid_dict()

    # image x unit mesh: a frame batch, and the sharded stream
    frames = mg.stream_frames()
    imesh = image_unit_mesh(2, devices)

    def one_card_frame(f):
        sr, ir = engine.inspect_image(f, grid, seg, defect, exclusions=excl)
        return mg.record(f, sr.masks, ir.defect_masks, ir.valid, ir.areas,
                         ir.verdicts)

    one = {"frames": [one_card_frame(f) for f in frames]}
    batch = np.stack(frames[:2])
    (v, a, found, masks, dmasks), first, times = timed(
        lambda: inspect_image_batch_sharded(
            batch, grid, seg, defect, exclusions=excl, mesh=imesh
        ),
        runs,
    )
    many = {"frames": [
        mg.record(frames[j], masks[j], dmasks[j], found[j], a[j], v[j])
        for j in range(2)
    ]}
    check("image_unit_batch", {"frames": one["frames"][:2]}, many)
    report("image_unit_batch", first, times, per=2)

    results, first, times = timed(
        lambda: list(streaming.stream_inspect_sharded(
            frames, grid, seg, defect, exclusions=excl, mesh=imesh,
            fetch_masks=True,
        )),
        runs,
    )
    many = {"frames": [
        mg.record(f, r.seg_masks, r.defect_masks, r.valid, r.areas,
                  r.verdicts)
        for f, r in zip(frames, results)
    ]}
    check("stream_sharded", one, many)
    report("stream_sharded", first, times, per=len(frames))

    # row-strip mesh: one whole-image unit split into n strips
    smesh = strip_mesh(devices)
    x = jnp.asarray(image)[None]
    m1 = np.asarray(jax.jit(lambda a: engine.raw_segment(a, seg))(x))[0]
    d1 = jax.tree.map(
        np.asarray, engine._defect_device(x, jnp.asarray(m1)[None],
                                          params=defect)
    )
    one = mg.record(image, m1[None], d1[0], d1[1], d1[2], d1[3])

    def strips():
        m = segment_image_sharded(image, seg, mesh=smesh)
        dm, f_, a_, v_ = defect_image_sharded(image, m, defect, mesh=smesh)
        return m, dm, f_, a_, v_

    (m, dm, f_, a_, v_), first, times = timed(strips, runs)
    check(f"strip_mesh_{n}", one,
          mg.record(image, m[None], dm[None], [f_], [a_], [v_]))
    report(f"strip_mesh_{n}", first, times)


def card_info() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    for line in out.splitlines():
        log(f"card: {line.strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card mesh paths")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform}",
              file=sys.stderr)
        return 2
    if args.multi:
        if len(devices) < 4:
            print(f"chip_smoke --multi: needs 4 GPUs, found {len(devices)}",
                  file=sys.stderr)
            return 2
        devices = devices[:4]
    log(f"jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    card_info()
    t0 = time.perf_counter()
    try:
        if args.multi:
            run_multi(devices)
        else:
            run_single()
    except ParityError as e:
        print(f"chip_smoke: parity failed: {e}", file=sys.stderr)
        return 1
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
