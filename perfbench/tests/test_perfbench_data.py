"""The benchmark's data files: cells, configurations, traffic and metrics
load by name; the traffic pool is deterministic per seed; the
configuration files are the port's published presets; a new cell is new
files only."""

import json
import os
import re
import shutil

import numpy as np
import pytest

from perfbench import spec, system, traffic
from tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keeps_the_contract_shape():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and b["command"][:3] == ["python3", "-m", "perfbench.run"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for k in ("end_to_end", "per_layer") for m in b[k])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e and all(m["moves"] in e2e for m in b["per_layer"])
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in b["configs"]:
        assert c["file"].startswith("perfbench/") and os.path.exists(os.path.join(ROOT, c["file"]))


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cells_load_by_name(workload):
    cell = spec.load(ROOT, workload)
    w = {x["name"]: x for x in bench()["workloads"]}[workload]
    assert cell.config["name"] == w["config"] and cell.chips == w["chips"] == 1
    assert {m.name for m in cell.end_to_end} >= {"img_per_s", "latency_p95_ms", "setup_s"}
    assert len(cell.per_layer) == 7 and all(callable(m.reader) for m in cell.per_layer)
    assert callable(cell.loop) and callable(cell.build)
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert ("latency_p50_ms" in {m.name for m in cell.end_to_end}) == (workload == "swinl-1280x1920-b1")


def test_a_fourth_cell_is_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["workloads"].append({"name": "r50-608x608-b1", "config": "r50-bf16", "traffic": "608x608-b1", "chips": 1,
                           "why": "test cell"})
    for m in b["per_layer"]:
        m["workloads"].append("r50-608x608-b1")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "perfbench/traffic/608x608-b1.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 1, "canvas": [608, 608], "pool": 8,
         "sizes": {"kind": "long_side", "long": 640, "aspect": [0.5, 2.0]}, "trace_requests": 4,
         "check_requests": 2}))
    (root / "perfbench/limits/r50-608x608-b1.json").write_text(json.dumps({"limits": {"fwd.miss": 0.5}}))
    cell = spec.load(str(root), "r50-608x608-b1")
    assert cell.traffic["canvas"] == [608, 608] and cell.limits == {"fwd.miss": 0.5}
    assert len(cell.per_layer) == 7 and cell.config["name"] == "r50-bf16"
    # BENCHMARK.json gained entries; no file of the harness changed
    assert all(p.read_bytes() == data for p, data in before.items() if p.name != "BENCHMARK.json")


PACED = '''
import time


def run(window):
    """One request every ``interval_s``, its latency from when it was due."""
    interval, k = window.run.cell.traffic["interval_s"], 0
    while not window.closed():
        due = window.t0 + k * interval
        time.sleep(max(0.0, due - time.perf_counter()))
        window.serve(window.pool.request(k, window.batch), sent=due)
        k += 1
'''

EAGER = '''
import torch

from perfbench.system import DTYPES, Tap, port_config


def build(cfg, state_dict, canvas, batch, device):
    from codetr_torch.inferencer import Inferencer
    from codetr_torch.models.codetr import CoDETR, to_compute_dtype

    dtype = DTYPES[cfg["dtype"]]
    with torch.device(device):
        model = CoDETR(port_config(cfg))
    model.load_state_dict(state_dict, strict=True)
    model = to_compute_dtype(model, dtype).eval()
    tap = Tap(model)
    return Inferencer(model, height=canvas[0], width=canvas[1], batch_size=batch, compiled_fn=tap,
                      input_dtype=dtype, device=device), tap
'''


def test_a_cell_with_a_new_loop_and_a_new_forward_is_new_files_only(tmp_path):
    """An open loop at a fixed interval and the model's eager forward, each a
    new file named by a new traffic file and a new configuration file: the
    cell loads by name and a whole run of it on the CPU is correct."""
    import time

    import tiny
    from perfbench import harness

    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tiny-eager", "source": "test", "file": "perfbench/configs/tiny-eager.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-eager-paced", "config": "tiny-eager", "traffic": "paced", "chips": 1,
                           "why": "test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "perfbench/configs/tiny-eager.json").write_text(json.dumps(dict(tiny.config(), forward="eager")))
    (root / "perfbench/traffic/paced.json").write_text(json.dumps(dict(tiny.TRAFFIC, loop="paced",
                                                                        interval_s=0.05)))
    (root / "perfbench/limits/tiny-eager-paced.json").write_text(json.dumps({"limits": tiny.LIMITS}))
    (root / "perfbench/loops/paced.py").write_text(PACED)
    (root / "perfbench/forwards/eager.py").write_text(EAGER)
    cell = spec.load(str(root), "tiny-eager-paced")
    assert all(p.read_bytes() == data for p, data in before.items() if p.name != "BENCHMARK.json")
    r = harness.run_cell(cell, 2**31 + 11, 0.6, False, "cpu", time.perf_counter())
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 2 and set(r["metrics"]) >= {"img_per_s", "latency_p95_ms", "setup_s"}


@pytest.mark.parametrize("name,preset", [("swinl-bf16", "co_dino_swin_l"), ("r50-bf16", "co_dino_r50")])
def test_configuration_files_are_the_published_presets(name, preset):
    from codetr_torch import config as C

    with open(os.path.join(ROOT, "perfbench/configs", f"{name}.json")) as f:
        cfg = json.load(f)
    assert system.port_config(cfg) == getattr(C, preset)()
    assert cfg["reduced"] == [] and cfg["dtype"] == "bfloat16"


def test_tiny_configuration_is_the_port_test_preset_with_more_queries():
    import dataclasses

    from codetr_torch.config import tiny_test_config

    import tiny

    want = tiny_test_config()
    tf = dataclasses.replace(want.head.transformer, two_stage_num_proposals=60)
    want = dataclasses.replace(want, head=dataclasses.replace(want.head, transformer=tf, max_per_img=40))
    assert system.port_config(tiny.config()) == want


@pytest.mark.parametrize("name", ["1280x1920-b1", "768x1152-b4"])
def test_traffic_pool_is_deterministic_per_seed(name):
    with open(os.path.join(ROOT, "perfbench/traffic", f"{name}.json")) as f:
        tr = json.load(f)
    tr = dict(tr, pool=8 if tr["sizes"]["kind"] == "list" else 6)
    a, b, c = (traffic.make_pool(tr, s) for s in (2**31 + 5, 2**31 + 5, 7))
    assert all(np.array_equal(x, y) for x, y in zip(a.images, b.images)) and np.array_equal(a.order, b.order)
    assert not all(np.array_equal(x, y) for x, y in zip(a.images, c.images))
    assert sorted(x.shape for x in a.images) == sorted(x.shape for x in c.images)  # same work, any seed
    assert all(x.dtype == np.uint8 and x.shape[2] == 3 for x in a.images)


def test_traffic_sizes():
    hw = traffic.sizes({"pool": 32, "sizes": {"kind": "list", "hw": [[1080, 1920], [1280, 1920], [720, 1280],
                                                                       [1080, 1440]], "both_orientations": True}})
    assert len(hw) == 32 and hw.count((1920, 1080)) == 4 and hw.count((1080, 1920)) == 4
    hw = traffic.sizes({"pool": 64, "sizes": {"kind": "long_side", "long": 640, "aspect": [0.5, 2.0]}})
    assert len(hw) == 64 and all(max(s) == 640 and min(s) >= 320 for s in hw)
    assert sum(w > h for h, w in hw) == 32
    with pytest.raises(ValueError):
        traffic.sizes({"pool": 30, "sizes": {"kind": "list", "hw": [[8, 8], [8, 16]], "both_orientations": True}})
