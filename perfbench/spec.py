"""A cell as ``BENCHMARK.json`` and the files it names describe it, found
by name under the checkout's root:

- the cell: ``BENCHMARK.json``'s ``workloads`` entry (config, traffic,
  chips);
- its configuration: the ``configs`` entry's ``file``;
- its traffic: ``perfbench/traffic/<traffic>.json``;
- how the window sends that traffic: ``perfbench/loops/<loop>.py``, the
  traffic file's ``loop``;
- the served program: ``perfbench/forwards/<forward>.py``, the
  configuration file's ``forward``;
- its correctness limits: ``perfbench/limits/<cell>.json``;
- its metrics: the ``end_to_end`` and ``per_layer`` entries whose
  ``workloads`` list holds the cell (or that have no such list), each read
  by ``perfbench/metrics/<name>.py``.

Adding a cell, a configuration, a traffic mix, a loop, a forward or a
metric adds files and entries; it edits none of this code.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

PACKAGE = "perfbench"


@dataclass
class Metric:
    name: str
    unit: str
    reader: Callable  # read(run) -> float or None


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    loop: Callable  # run(window) -> None: sends the requests (``harness.Window``)
    build: Callable  # build(cfg, state_dict, canvas, batch, device) -> (Inferencer, Tap)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def plugin(root: str, kind: str, name: str, attr: str) -> Callable:
    """``attr`` of ``perfbench/<kind>/<name>.py`` (a name may hold dots, so
    the file is loaded by path)."""
    path = os.path.join(root, PACKAGE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{PACKAGE}.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, attr)


def reader(root: str, name: str) -> Callable:
    """``read`` of ``perfbench/metrics/<name>.py``."""
    return plugin(root, "metrics", name, "read")


def _metrics(root: str, entries: List[dict], cell: str) -> List[Metric]:
    return [Metric(m["name"], m["unit"], reader(root, m["name"]))
            for m in entries if "workloads" not in m or cell in m["workloads"]]


def load(root: str, workload: str, bench: str = "BENCHMARK.json") -> Cell:
    b = _json(os.path.join(root, bench))
    cells = {w["name"]: w for w in b["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in {bench}; have {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    tr = _json(os.path.join(root, PACKAGE, "traffic", f"{w['traffic']}.json"))
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=config,
        traffic=tr,
        limits=_json(os.path.join(root, PACKAGE, "limits", f"{workload}.json"))["limits"],
        end_to_end=_metrics(root, b["end_to_end"], workload),
        per_layer=_metrics(root, b["per_layer"], workload),
        loop=plugin(root, "loops", tr["loop"], "run"),
        build=plugin(root, "forwards", config["forward"], "build"),
    )
