"""What the package needs from its environment: where the compile cache
goes, and that the main path runs without OpenCV."""

import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]

_PRINT_CACHE = (
    "import tpu_inspect, jax; print(jax.config.jax_compilation_cache_dir)"
)


def _run(code, **env_over):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_over, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=REPO, timeout=600)
    assert p.returncode == 0, p.stderr
    return p.stdout


def test_compile_cache_follows_environment(tmp_path):
    d = str(tmp_path / "cache")
    assert _run(_PRINT_CACHE, JAX_COMPILATION_CACHE_DIR=d).strip() == d


def test_compile_cache_defaults_inside_checkout():
    assert _run(_PRINT_CACHE).strip() == str(REPO / ".jax_cache")


def test_main_path_runs_without_cv2():
    # None in sys.modules makes every `import cv2` raise ImportError
    out = _run(
        "import sys; sys.modules['cv2'] = None\n"
        "from tpu_inspect import engine, streaming, synthetic\n"
        "from tpu_inspect.config import DefectParams, GridParams, "
        "SegmentationParams\n"
        "g = GridParams(base_unit=(4, 4, 40, 36), units_x=2)\n"
        "img = synthetic.make_mold_image(g, (48, 96), seed=1, "
        "defect_rate=1.0)\n"
        "s, i = engine.inspect_image(img, g, SegmentationParams(), "
        "DefectParams(min_area=3))\n"
        "r = next(streaming.stream_inspect([img], g, SegmentationParams(), "
        "DefectParams(min_area=3)))\n"
        "assert (r.verdicts == i.verdicts).all()\n"
        "print(s.masks.shape, i.verdicts.shape)\n"
    )
    assert "(2, 36, 40) (2,)" in out


def test_gray_u8_passes_through_without_cv2(monkeypatch):
    from tpu_inspect.imageio import _to_gray_u8

    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    out = _to_gray_u8(img)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, img)


def test_gray_u16_scales_without_cv2(monkeypatch):
    from tpu_inspect.imageio import _to_gray_u8

    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.array([[0, 255, 256, 65535], [512, 1000, 40000, 257]],
                   dtype=np.uint16)
    out = _to_gray_u8(img)
    assert out.dtype == np.uint8
    np.testing.assert_array_equal(out, (img / 256).astype(np.uint8))
