"""bench.py's device table and platform gate (its measurements need a
GPU; see chip_smoke.py for the card run)."""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


def test_published_bandwidth_of_h100():
    assert bench.hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0


@pytest.mark.parametrize("kind", ["NVIDIA H200", "NVIDIA A100-SXM4-80GB",
                                  "cpu"])
def test_unknown_device_kind_raises(kind):
    with pytest.raises(KeyError, match="no published bandwidth"):
        bench.hbm_gbps(kind)


def test_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""
