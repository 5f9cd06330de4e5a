"""Device time (ms an image) of the operations launched inside the
Inferencer's ``postprocess`` ranges of the traced requests: the score gate,
per-class soft-NMS and rescale (``ops/nms.py``), on the card one replay of
a captured CUDA graph a batch (``runtime/aot.py:Replay``) with its input
and output copies.  The profiler drops a replay's kernels, so the replay
counts as the time between CUDA events around it, which holds any wait of
the device for the graph's launch; on the card nothing is read without
such a replay in the trace."""

from perfbench.trace import REPLAY


def read(run):
    if run.trace is None or not run.traced_images:
        return None
    ops = run.trace.launched_in("postprocess")
    if not ops or (run.device.type == "cuda" and not any(op.name == REPLAY for op in ops)):
        return None
    return sum(op.dur for op in ops) / 1e3 / run.traced_images
