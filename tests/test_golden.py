"""The committed golden record equals the OpenCV oracle's answer on the
same seeded inputs, case by case (tools/make_golden.py)."""

import pathlib
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import make_golden  # noqa: E402


@pytest.mark.parametrize("case", make_golden.CASES)
def test_golden_matches_oracle(case):
    golden = make_golden.load_golden()
    assert sorted(golden) == sorted(make_golden.CASES)
    assert make_golden.diff(golden[case], make_golden.oracle_record(case)) == []
