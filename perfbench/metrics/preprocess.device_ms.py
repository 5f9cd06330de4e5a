"""Device time (ms an image) of the operations launched inside the
Inferencer's ``preprocess`` ranges of the traced requests: the upload,
the resize, normalise, pad and mask (``utils/preprocess.py``)."""


def read(run):
    if run.trace is None or not run.traced_images:
        return None
    ops = run.trace.launched_in("preprocess")
    return sum(op.dur for op in ops) / 1e3 / run.traced_images if ops else None
