"""Headless CLI — the engine's button handlers without the buttons.

Replaces the reference's UI-driven flows with commands:

  python -m tpu_inspect.cli segment  --grid grid.json --image mold.tif --out out/
  python -m tpu_inspect.cli inspect  --grid grid.json --image a.tif b.tif --out out/
  python -m tpu_inspect.cli gridgen  --base 251,232,316,315 --units 4x6 \
      --blocks 2x1 --unit-space 133,136 --block-space 252,0 --out grid.json
  python -m tpu_inspect.cli stream   --grid grid.json frame0.tif frame1.tif ...
  python -m tpu_inspect.cli bench

`inspect` treats the first image as the reference capture (anchors recorded)
and later images as production captures (exclusions re-aligned), matching
the reference's multi-image workflow. `stream` is the deployment-shaped
flow: decode-ahead native loader + pipelined device dispatch, one JSONL
verdict line per frame.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _parse_pair(s: str, sep: str) -> tuple[int, int]:
    a, b = s.split(sep)
    return int(a), int(b)


def _seg_params(args):
    from tpu_inspect.config import SegmentationParams

    return SegmentationParams(
        method=args.seg_method,
        gaussian_blur=args.gaussian_blur,
        morph_kernel=args.morph_kernel,
        adapt_block=args.adapt_block,
        adapt_C=args.adapt_c,
    )


def _defect_params(args):
    from tpu_inspect.config import DefectParams

    return DefectParams(
        method=args.defect_method,
        threshold=args.threshold,
        min_area=args.min_area,
        erode_px=args.erode_px,
    )


def _add_param_flags(p):
    p.add_argument("--seg-method", choices=["otsu", "adaptive"], default="otsu")
    p.add_argument("--gaussian-blur", type=int, default=3)
    p.add_argument("--morph-kernel", type=int, default=3)
    p.add_argument("--adapt-block", type=int, default=51)
    p.add_argument("--adapt-c", type=int, default=10)
    p.add_argument("--defect-method", choices=["threshold", "canny"], default="threshold")
    p.add_argument("--threshold", type=int, default=24)
    p.add_argument("--min-area", type=int, default=20)
    p.add_argument("--erode-px", type=int, default=6)


def cmd_gridgen(args):
    from tpu_inspect.config import GridParams
    from tpu_inspect.geometry import grid_boxes
    from tpu_inspect.persistence import GridDocument, grid_metadata, save_grid

    bx, by, bw, bh = (int(v) for v in args.base.split(","))
    ux, uy = _parse_pair(args.units, "x")
    blx, bly = _parse_pair(args.blocks, "x")
    sux, suy = _parse_pair(args.unit_space, ",")
    sbx, sby = _parse_pair(args.block_space, ",")
    grid = GridParams(
        base_unit=(bx, by, bw, bh),
        units_x=ux, units_y=uy, blocks_x=blx, blocks_y=bly,
        unit_space_x=sux, unit_space_y=suy,
        block_space_x=sbx, block_space_y=sby,
    )
    iw, ih = (None, None)
    if args.image_size:
        iw, ih = _parse_pair(args.image_size, "x")
    doc = GridDocument(
        boxes=grid_boxes(grid), metadata=grid_metadata(grid, iw, ih)
    )
    save_grid(doc, args.out)
    print(f"wrote {len(doc.boxes)} boxes to {args.out}")


def _load_session(args):
    from tpu_inspect.session import InspectionSession

    sess = InspectionSession(
        seg_params=_seg_params(args), defect_params=_defect_params(args)
    )
    for path in args.image:
        sess.add_image(path)
    sess.switch_to(args.image[0])
    n = sess.import_grid(args.grid)
    print(f"grid: {n} units; reference image: {args.image[0]}", file=sys.stderr)
    return sess


def cmd_segment(args):
    sess = _load_session(args)
    sess.run_segmentation()
    if args.out:
        csv_path = sess.export_masks(args.out)
        print(f"masks + {csv_path} written")
    if getattr(args, "thumbnails", None):
        n = sess.export_thumbnails(args.thumbnails)
        print(f"exported {n} thumbnails to {args.thumbnails}")


def cmd_inspect(args):
    sess = _load_session(args)
    report = {}
    for path in args.image:
        sess.switch_to(path)
        insp = sess.run_inspection()
        report[path] = {
            "ng_units": [int(i) for i in np.nonzero(insp.verdicts)[0]],
            "ng_count": int(insp.verdicts.sum()),
            "unit_count": int(insp.verdicts.shape[0]),
            "areas": {
                str(i): int(a)
                for i, a in enumerate(insp.areas)
                if insp.valid[i]
            },
        }
        print(
            f"{path}: {report[path]['ng_count']}/{report[path]['unit_count']} units NG",
            file=sys.stderr,
        )
        if args.out:
            img_dir = os.path.join(
                args.out, os.path.splitext(os.path.basename(path))[0]
            )
            sess.export_masks(img_dir)
        if getattr(args, "thumbnails", None):
            img_dir = os.path.join(
                args.thumbnails, os.path.splitext(os.path.basename(path))[0]
            )
            sess.export_thumbnails(img_dir)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "inspection.json"), "w") as f:
            json.dump(report, f, indent=2)
    print(json.dumps(report))


def cmd_stream(args):
    """Inline inspection of a capture stream (file list), pipelined.

    The deployment-shaped flow: decode-ahead via the native loader, device
    pipeline dispatched ahead of results, one JSONL line per frame. Anchors
    come from the grid JSON (v2 exclusion_alignment) when present; otherwise
    the first frame is treated as the reference capture and its centroids
    anchor the rest of the stream (the reference tool's first-image-is-
    reference rule, indexing_ui.py:1196-1208)."""
    from itertools import chain

    from tpu_inspect.engine import segment_units
    from tpu_inspect.imageio import load_gray, load_gray_stream
    from tpu_inspect.persistence import load_grid
    from tpu_inspect.streaming import stream_inspect
    from tpu_inspect.synthetic import crop_units

    doc = load_grid(args.grid)
    grid = doc.grid_params
    if grid is None:
        raise SystemExit(f"grid JSON {args.grid} has no usable geometry")

    frames = list(args.frames)
    anchors = dict(doc.ref_centroids)
    ref = None
    if not anchors and doc.exclusions:
        ref = load_gray(frames[0])
        anchors = segment_units(
            crop_units(ref, grid), _seg_params(args)
        ).centroid_dict()
        print(f"anchors recorded from reference frame {frames[0]}",
              file=sys.stderr)

    # frame 0 decoded for anchors feeds the stream directly (no re-decode);
    # the rest come through the native decode-ahead loader
    if ref is not None:
        images = chain(
            [ref], load_gray_stream(frames[1:], threads=args.decode_threads)
        )
    else:
        images = load_gray_stream(frames, threads=args.decode_threads)

    total_ng = 0
    for res in stream_inspect(
        images,
        grid,
        _seg_params(args),
        _defect_params(args),
        exclusions=doc.exclusions,
        ref_centroids=anchors or None,
        prefetch=args.prefetch,
    ):
        total_ng += res.ng_count
        print(
            json.dumps(
                {
                    "frame": frames[res.index],
                    "index": res.index,
                    "ng_count": res.ng_count,
                    "unit_count": int(res.verdicts.shape[0]),
                    "ng_units": [int(i) for i in np.nonzero(res.verdicts)[0]],
                }
            ),
            flush=True,
        )
    print(f"stream done: {len(frames)} frames, {total_ng} unit NGs",
          file=sys.stderr)


PROFILE_STEPS = 5  # traced steps of `cli profile`
PROFILE_TOP = 25  # longest kernels it lists


def cmd_profile(args):
    """Device-profile the standard workload; print per-stage device time.

    Traces a few steady calls of the fused step on the standard workload
    (48 units of 316x315 on 4096x3000) under ``jax.profiler.trace`` and
    attributes every GPU kernel to the engine's named scope that encloses
    it (tpu_inspect.utils.xprof). Prints per step: device ms and launches
    by stage, device busy time and idle share, the longest idle gaps and
    the longest kernels."""
    import tempfile
    import time

    import jax
    import jax.numpy as jnp

    from tpu_inspect.engine import _inspect_image_device
    from tpu_inspect.synthetic import standard_workload
    from tpu_inspect.utils import xprof

    wl = standard_workload()
    fargs = tuple(jnp.asarray(wl[k]) for k in (
        "image", "origins", "rects", "circles", "ref_centroids", "ref_valid"))
    dev = jax.devices()[0]
    print(f"compiling on {dev} ...", file=sys.stderr)
    step = _inspect_image_device.lower(
        *fargs, seg=_seg_params(args).validated(),
        defect=_defect_params(args).validated(), is_reference=True,
        unit_hw=wl["unit_hw"], with_defects=True,
    ).compile()
    names = xprof.hlo_op_names(step.as_text())
    jax.block_until_ready(step(*fargs))  # warm
    n = PROFILE_STEPS
    with tempfile.TemporaryDirectory(prefix="tpu_inspect_prof") as d:
        with jax.profiler.trace(d):
            t0 = time.perf_counter()
            for _ in range(n):
                jax.block_until_ready(step(*fargs))
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        evs = xprof.trace_events(d)
    if not evs:
        print(
            "no GPU device plane in trace (host-only platform?); "
            "run on a GPU for per-stage device time",
            file=sys.stderr,
        )
        return
    by_stage, by_kernel, unmapped = xprof.stage_totals(evs, names)
    busy, window = xprof.busy_ns(evs)
    gaps = xprof.idle_gaps(evs)
    print(f"device: {dev.device_kind}; "
          f"{args.seg_method}/{args.defect_method}; "
          f"{n} traced steps; wall {wall_ms:.3f} ms/step under the tracer")
    print(f"kernels: {len(evs) / n:.0f}/step ({unmapped / n:.0f} without "
          f"an HLO op name)")
    print(f"device busy {busy / n / 1e6:.3f} ms/step, window "
          f"{window / n / 1e6:.3f} ms/step, idle share "
          f"{1 - busy / window:.3f}")
    print(f"gaps >= 10 us: {len(gaps) / n:.1f}/step, "
          f"{sum(g for g, _, _ in gaps) / n / 1e6:.3f} ms/step; longest:")
    for g, before, after in gaps[:8]:
        print(f"  {g / 1e6:8.3f} ms  after {before[:60]}  before {after[:60]}")
    print("stage               ms/step  launches/step")
    for st, (ns, c) in sorted(by_stage.items(), key=lambda kv: -kv[1][0]):
        print(f"  {st:16s} {ns / n / 1e6:9.3f}  {c / n:8.1f}")
    print("top kernels         ms/step  launches/step")
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    for k, (ns, c) in ranked[:PROFILE_TOP]:
        print(f"  {ns / n / 1e6:9.3f}  {c / n:8.1f}  {k}")


def cmd_bench(args):
    import bench

    bench.main()


def cmd_ui(args):
    from tpu_inspect.ui.server import main as ui_main

    argv = list(args.images)
    if args.grid:
        argv += ["--grid", args.grid]
    argv += ["--port", str(args.port), "--host", args.host]
    ui_main(argv)


def cmd_doctor(args):
    """Deployment diagnostics: devices, compile cache, native IO."""
    import jax

    from tpu_inspect import native

    try:
        devs = jax.devices()
        print(f"platform: {devs[0].platform}")
        print(f"device_kind: {devs[0].device_kind}")
        print(f"device count: {len(devs)}")
    except RuntimeError as e:  # no usable backend: still report the rest
        print(f"devices: UNAVAILABLE ({e})")
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    lib = native.get_lib()
    print(
        "native io: "
        + (lib.tin_version().decode() if lib else "unavailable (cv2 fallback)")
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tpu-inspect")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gridgen", help="generate a grid JSON from indexing params")
    g.add_argument("--base", required=True, help="x,y,w,h of the base unit")
    g.add_argument("--units", default="1x1")
    g.add_argument("--blocks", default="1x1")
    g.add_argument("--unit-space", default="0,0")
    g.add_argument("--block-space", default="0,0")
    g.add_argument("--image-size", default=None, help="WxH")
    g.add_argument("--out", required=True)
    g.set_defaults(fn=cmd_gridgen)

    for name, fn in [("segment", cmd_segment), ("inspect", cmd_inspect)]:
        p = sub.add_parser(name)
        p.add_argument("--grid", required=True)
        p.add_argument("--image", nargs="+", required=True)
        p.add_argument("--out", default=None)
        p.add_argument(
            "--thumbnails",
            default=None,
            metavar="DIR",
            help="also export per-unit crop PNGs (unit_%%04d.png) to DIR",
        )
        _add_param_flags(p)
        p.set_defaults(fn=fn)

    s = sub.add_parser(
        "stream",
        help="pipelined inline inspection of a frame stream (JSONL output)",
    )
    s.add_argument("--grid", required=True)
    s.add_argument("frames", nargs="+", help="capture frames, in order")
    s.add_argument("--prefetch", type=int, default=2,
                   help="device dispatches kept in flight")
    s.add_argument("--decode-threads", type=int, default=3,
                   help="native decode worker threads")
    _add_param_flags(s)
    s.set_defaults(fn=cmd_stream)

    b = sub.add_parser("bench", help="run the standard benchmark")
    b.set_defaults(fn=cmd_bench)

    pr = sub.add_parser(
        "profile", help="per-stage GPU device time of the standard workload"
    )
    _add_param_flags(pr)
    pr.set_defaults(fn=cmd_profile)

    d = sub.add_parser(
        "doctor", help="print devices / compile-cache / native-IO status"
    )
    d.set_defaults(fn=cmd_doctor)

    u = sub.add_parser("ui", help="serve the interactive web client")
    u.add_argument("images", nargs="*", help="image files to preload")
    u.add_argument("--grid", default=None, help="grid JSON to import")
    u.add_argument("--port", type=int, default=8700)
    u.add_argument("--host", default="127.0.0.1")
    u.set_defaults(fn=cmd_ui)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
