"""Full-size pipeline parity on the GPU (skips elsewhere).

Run on a machine with a GPU:

    python -m pytest -m gpu -p no:xdist tests/test_gpu.py
"""

import pathlib
import sys

import pytest

import jax

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

pytestmark = pytest.mark.gpu


def test_full_size_single_card_parity(gpu_device, capsys):
    import chip_smoke

    chip_smoke.run_single(runs=1, analyse_memory=False)
    out = capsys.readouterr().out
    assert out.count("parity: exact") == 7


def test_full_size_four_card_parity(gpu_device, capsys):
    import chip_smoke

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 GPUs")
    chip_smoke.run_multi(jax.devices()[:4], runs=1)
    assert capsys.readouterr().out.count("parity: exact") == 5
