"""95th percentile of the window's request latencies (ms, host clock): from
handing the images to ``Inferencer.__call__`` to their ``Detections`` on
the host.  A failed request has no latency and counts in ``failed``."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies_ms, 95)) if run.latencies_ms else None
