"""Median of the window's request latencies (ms, host clock)."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms, 50)) if run.latencies_ms else None
