"""On the card (marked ``gpu``; skipped without one): the control of each
cell at the cell's own size fails the cell's limits, and a tiny run on the
card is correct."""

import json
import os
import time

import pytest

import tiny
from perfbench import calibrate, check, harness, spec
from tiny import ROOT


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", cells())
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_the_control_fails_the_cells_limits(cuda, workload, seed):
    cell = spec.load(ROOT, workload)
    ok, checks = check.judge(calibrate.control_readings(cell, seed, cuda), cell.limits)
    assert not ok, checks


@pytest.mark.gpu
def test_a_tiny_run_on_the_card_is_correct(cuda):
    # long enough for both traces after a third of the window (a profiler
    # start and stop take ~0.5 s each)
    r = harness.run_cell(tiny.cell(), 2**31 + 7, 6.0, True, cuda, time.perf_counter())
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert {"forward.device_ms", "device.idle_share"} <= set(r["metrics"])
