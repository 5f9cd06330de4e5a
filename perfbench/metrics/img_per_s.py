"""Images whose detections reached the host in the window, per second of
the window (host clock, all the window's work over all its time)."""


def read(run):
    return run.images / run.window_s if run.window_s > 0 else None
