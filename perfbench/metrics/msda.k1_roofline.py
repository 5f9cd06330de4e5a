"""K1, the encoder's deformable-attention kernel (``msda_tile_fwd_kernel``,
``csrc/msda_tiles.cuh`` through ``ops/msda.py``): its least time over its
mean device time a call, in %.  Least time is the larger of its FLOPs over
the dtype's peak and its bytes over the HBM bandwidth
(``perfbench/costs.py:k1_cost``).  Nothing if the trace holds no K1 call."""

import re

from perfbench import costs

K1 = re.compile(r"\bmsda_tile_fwd_kernel\b")


def read(run):
    peak = costs.peaks(run.card)
    if run.device_trace is None or peak is None:
        return None
    lo, hi = run.device_trace.window()
    calls = [op.dur for op in run.device_trace.ops if K1.search(op.name) and lo <= op.ts <= hi]
    if not calls:
        return None
    flops, nbytes = costs.k1_cost(run.cell.config, run.canvas, run.batch)
    least = max(flops / peak["flops"][run.cell.config["dtype"]], nbytes / peak["hbm_bytes_per_s"])
    return 100.0 * least / (sum(calls) / len(calls) / 1e6)
