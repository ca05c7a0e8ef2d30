"""The control comes out as not correct, on the card at each cell's own size.

The control is the reference computed one precision below the
configuration's (TF32 in matrix products and convolutions, where the
configuration states float32 with TF32 off), compared with the reference
as a run compares the program. It has to fail at least one of the cell's
limits. Needs a CUDA device (marker gpu; the fixture skips without one):

    python -m pytest -m gpu -p no:cacheprovider -o addopts="" benchmark/tests/test_bench_control_gpu.py
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.calibrate import readings

pytestmark = pytest.mark.gpu
SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_is_not_correct(cuda_device, cell):
    c = harness.cell(cell)
    got = readings(c, 2**31 + 501, cuda_device, ["control"])["control"]
    limits = c["work"]["limits"]
    assert any(got[k] > lim for k, lim in limits.items()), (got, limits)
