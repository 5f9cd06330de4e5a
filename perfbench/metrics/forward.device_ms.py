"""Device time (ms an image) of the operations launched inside the
Inferencer's ``forward`` ranges of the traced requests: the exported
program, backbone to the head's top-k (``models/*``, ``runtime/aot.py``)."""


def read(run):
    if run.trace is None or not run.traced_images:
        return None
    ops = run.trace.launched_in("forward")
    return sum(op.dur for op in ops) / 1e3 / run.traced_images if ops else None
