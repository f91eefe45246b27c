"""Per-stage device time from a ``jax.profiler`` trace.

Reads the newest ``*.xplane.pb`` of a trace directory with
``jax.profiler.ProfileData`` and attributes every kernel on the GPU's
stream lines to the innermost of the engine's ``jax.named_scope``s that
encloses it, through the op names in the compiled step's HLO metadata.
Also reduces the kernels to device busy time, idle share and idle gaps.

The reference has no profiling at all (SURVEY.md §5: "Tracing/profiling:
none"); this is the rebuild's observability subsystem, exposed via
``python -m tpu_inspect.cli profile``.
"""

from __future__ import annotations

import os
import re

# the engine's named scopes, outermost first (engine.py, ops/contour.py)
SCOPES = (
    "gather", "gauss", "thresh", "morph", "holefill", "seg_centroid",
    "exclusions",
    "defect_roi", "roi_erode", "roi_largest",
    "median_residual", "canny",
    "blob_filter", "cand_open", "blob_exterior", "label_fill", "label_fg",
)

_INSTR = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLS = re.compile(r"calls=%?([\w.\-]+)")


def hlo_op_names(hlo_text: str) -> dict[str, str]:
    """HLO instruction name -> metadata op_name (the named-scope path).

    A fusion without op_name metadata of its own takes the first op_name
    found in the computation it calls. Names are also keyed with "." as
    "_", the form kernel names take."""
    comp_ops: dict[str, list[str]] = {}
    instrs = []  # (name, own op_name, called computation)
    comp = None
    for line in hlo_text.splitlines():
        m = _INSTR.match(line)
        if m is None:
            if line.rstrip().endswith("{"):
                comp = line.split("(")[0].replace("ENTRY", "").strip()
                comp = comp.lstrip("%").strip()
                comp_ops.setdefault(comp, [])
            continue
        own = _OP_NAME.search(line)
        calls = _CALLS.search(line)
        if own and comp is not None:
            comp_ops[comp].append(own.group(1))
        instrs.append((m.group(1), own.group(1) if own else None,
                       calls.group(1) if calls else None))

    out = {}
    for name, own, calls in instrs:
        op = own or next(iter(comp_ops.get(calls, ())), None)
        if op:
            out[name] = op
            out[name.replace(".", "_")] = op
    return out


def stage_of(op_name: str) -> str:
    """Innermost engine scope on an op path ("other" when none)."""
    for p in reversed(op_name.split("/")):
        if p in SCOPES:
            return p
    return "other"


def find_xplane_files(trace_dir: str) -> list[str]:
    """All ``*.xplane.pb`` under a ``jax.profiler.trace`` output directory
    (they live in plugins/profile/<run>/), newest run first."""
    hits = []
    for root, _, files in os.walk(trace_dir):
        for fn in files:
            if fn.endswith(".xplane.pb"):
                hits.append(os.path.join(root, fn))
    return sorted(hits, key=os.path.getmtime, reverse=True)


def trace_events(
    trace_dir: str, plane: str = "/device:GPU:0", line: str = "Stream"
) -> list[tuple[str, str, float, float]]:
    """[(event name, hlo_op stat, start ns, duration ns)] on the lines whose
    names start with ``line``, of the planes whose names start with
    ``plane``, in the newest trace. The defaults pick the first GPU's
    kernels; ``[]`` when there is no trace or no such plane (a CPU run)."""
    from jax.profiler import ProfileData

    files = find_xplane_files(trace_dir)
    if not files:
        return []
    evs = []
    for p in ProfileData.from_file(files[0]).planes:
        if not p.name.startswith(plane):
            continue
        for ln in p.lines:
            if not ln.name.startswith(line):
                continue
            for e in ln.events:
                hlo = next((str(v) for k, v in e.stats if k == "hlo_op"), "")
                evs.append((e.name, hlo, float(e.start_ns),
                            float(e.duration_ns)))
    return evs


def busy_ns(evs) -> tuple[float, float]:
    """(union of event intervals, window from first start to last end)."""
    if not evs:
        return 0.0, 0.0
    spans = sorted((s, s + d) for _, _, s, d in evs)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, spans[-1][1] - spans[0][0]


def idle_gaps(evs, min_ns: float = 10e3):
    """[(gap ns, event before, event after)] between consecutive device
    activity, longest first."""
    spans = sorted((s, s + d, k) for k, _, s, d in evs)
    gaps, end, before = [], None, None
    for s, e, k in spans:
        if end is not None and s - end >= min_ns:
            gaps.append((s - end, before, k))
        if end is None or e >= end:
            end, before = e, k
    return sorted(gaps, reverse=True)


def stage_totals(evs, names: dict[str, str]):
    """Sum durations by stage and by "kernel [stage]".

    Returns ({stage: [ns, launches]}, {kernel: [ns, launches]}, number of
    events whose HLO op has no name in ``names``)."""
    by_stage: dict[str, list[float]] = {}
    by_kernel: dict[str, list[float]] = {}
    unmapped = 0
    for kname, hlo, _, dur in evs:
        op = names.get(hlo) or names.get(kname)
        if op is None:
            unmapped += 1
        st = stage_of(op or "")
        for table, key in ((by_stage, st), (by_kernel, f"{kname} [{st}]")):
            row = table.setdefault(key, [0.0, 0])
            row[0] += dur
            row[1] += 1
    return by_stage, by_kernel, unmapped
