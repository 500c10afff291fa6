"""On the card: the control (the reference one precision step below the
configuration's, in the program's place) fails its cell's limits, and the
program meets them, at each cell's own size. Skipped without a card."""
import time
from types import SimpleNamespace

import pytest

import tiny
from portbench import control, harness

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = harness.Cell(tiny.bench(), name, tiny.ROOT)
    ctx = SimpleNamespace(cell=cell, torch=card, device=card.device("cuda", 0), trace=False,
                          seed=3000000019, t_start=time.perf_counter())
    fn = control.serve_readings if cell.config["job"] == "serve" else control.chain_readings
    readings = fn(ctx, cell.job())
    limits = cell.config["limits"]
    assert any(r["control"] > limits[k] for k, r in readings.items() if k in limits), readings
    assert all(r["program"] <= limits[k] for k, r in readings.items() if k in limits), readings
