"""Every dotted API path the docs mention must import and resolve.

Round-4 verdict item 4: README cited ``tpu_inspect.parallel.
inspect_units_sharded`` while ``parallel/__init__.py`` was empty, and
PARITY/PERF cited ``parallel.stream_inspect_sharded`` for a function living
in ``streaming.py``. This scans the user-facing docs for backticked dotted
identifiers rooted in the package (or one of its top-level modules) and
resolves each one, so doc/API drift fails CI instead of a reader.
"""

import importlib
import pathlib
import re

import pytest

import tpu_inspect

REPO = pathlib.Path(__file__).resolve().parents[1]
DOCS = ["README.md", "PARITY.md", "PERF.md"]

# module names a bare `mod.attr` doc reference may be rooted in
_TOP_MODULES = {
    "parallel", "streaming", "engine", "geometry", "imageio", "persistence",
    "render", "session", "viewport", "config", "cli", "synthetic", "ops",
    "oracle", "utils", "native",
}

_TOKEN = re.compile(r"`([A-Za-z_][\w.]*(?:\.[A-Za-z_]\w*)+)(?:\(\))?`")


def _doc_paths():
    found = set()
    for name in DOCS:
        text = (REPO / name).read_text()
        for tok in _TOKEN.findall(text):
            if "." not in tok:
                continue
            root = tok.split(".", 1)[0]
            last = tok.rsplit(".", 1)[1]
            # skip file names (`engine.py`, `grid.json`, …) and version-ish
            if last in {"py", "json", "md", "png", "csv", "cc", "html",
                        "txt", "jsonl"}:
                continue
            if root == "tpu_inspect":
                found.add(tok)
            elif root in _TOP_MODULES:
                found.add("tpu_inspect." + tok)
    return sorted(found)


@pytest.mark.parametrize("path", _doc_paths())
def test_doc_path_resolves(path):
    parts = path.split(".")
    # longest importable module prefix, then getattr the rest
    obj = None
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
            rest = parts[i:]
            break
        except ImportError:
            continue
    assert obj is not None, f"no importable prefix of {path}"
    for attr in rest:
        assert hasattr(obj, attr), f"{path}: {obj.__name__} has no {attr!r}"
        obj = getattr(obj, attr)


def test_readme_usage_snippet_executes(tmp_path, monkeypatch):
    """The README's Usage code block, executed nearly verbatim: grid.json
    comes from the README's own `cli gridgen` command, the image is a
    synthetic capture of that grid."""
    from tpu_inspect import cli
    from tpu_inspect.synthetic import make_mold_image

    monkeypatch.chdir(tmp_path)
    cli.main(["gridgen", "--base", "251,232,316,315", "--units", "4x6",
              "--blocks", "2x1", "--unit-space", "133,136",
              "--block-space", "252,0", "--out", "grid.json"])

    from tpu_inspect.config import SegmentationParams, DefectParams
    from tpu_inspect.persistence import load_grid
    from tpu_inspect.engine import inspect_image

    doc = load_grid("grid.json")
    image = make_mold_image(doc.grid_params, (3000, 4096), seed=3,
                            defect_rate=0.3)
    seg_res, insp = inspect_image(image, doc.grid_params,
                                  SegmentationParams(), DefectParams(),
                                  exclusions=doc.exclusions)
    assert insp.verdicts.dtype == bool
    assert insp.verdicts.shape == (doc.grid_params.num_units,) == (48,)
    assert seg_res.masks.shape[0] == doc.grid_params.num_units


def test_readme_snippet_names_exist():
    """The specific round-4 drift cases, pinned explicitly."""
    from tpu_inspect import parallel, streaming

    for name in ("inspect_units_sharded", "inspect_image_batch_sharded",
                 "unit_mesh", "image_unit_mesh"):
        assert callable(getattr(parallel, name))
    assert callable(streaming.stream_inspect_sharded)
