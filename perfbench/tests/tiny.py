"""A tiny cell for the CPU tests: a miniature Co-DINO (``tiny.json``: the
port's ``tiny_test_config`` with 60 queries and 40 detections) at a 64x96
canvas, batches of 2.  Its limits test the harness's logic, not the
program's precision: at these widths bf16's rounding is not averaged
away, so sound runs (seeds 1-12 on the CPU: ``fwd.unmatched_share`` 0-0.075,
``fwd.nlogit_gap_med`` 0.0089-0.046, ``_p90`` 0.018-0.081,
``fwd.box_gap_p90`` 0.0085-0.038) come near the float8 control (seeds 1-6:
0.075-0.275, 0.095-0.35, 0.53 or infinite, 0.08-0.20); the control fails
the ``post`` numbers (``post.score_gap`` 1.2e-4-4.9e-4 and ``post.box_gap``
0.53-0.69 px, the program 0 and 0).  Planted in the program's outputs
(``calibrate.FAULTS``): boxes x 1.3 leave 0.95-1 unmatched, boxes shifted
by 0.15 of their width read ``fwd.box_gap_p90`` 0.154-0.170, every other
score's logit + 1 reads ``fwd.nlogit_gap_p90`` 0.92-1.98.  The cells' own
limits are set at their sizes on the card (PERF.md)."""

import json
import os

from perfbench import spec

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
TRAFFIC = {"loop": "closed", "clients": 1, "batch": 2, "canvas": [64, 96], "pool": 8,
           "sizes": {"kind": "long_side", "long": 80, "aspect": [0.5, 2.0]},
           "trace_requests": 2, "check_requests": 2}
LIMITS = {"fwd.unmatched_share": 0.15, "fwd.nlogit_gap_med": 0.2, "fwd.nlogit_gap_p90": 0.3, "fwd.box_gap_p90": 0.08,
          "post.score_gap": 2e-5, "post.box_gap": 0.01}


def config() -> dict:
    with open(os.path.join(HERE, "tiny.json")) as f:
        return json.load(f)


def cell(limits=None, metrics=True) -> spec.Cell:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)

    def ms(entries):
        return [spec.Metric(m["name"], m["unit"], spec.reader(ROOT, m["name"])) for m in entries] if metrics else []

    cfg = config()
    return spec.Cell("tiny", 1, cfg, dict(TRAFFIC), dict(LIMITS if limits is None else limits),
                     ms(b["end_to_end"]), ms(b["per_layer"]), spec.plugin(ROOT, "loops", TRAFFIC["loop"], "run"),
                     spec.plugin(ROOT, "forwards", cfg["forward"], "build"))
