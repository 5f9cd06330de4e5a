"""Share (%) of the traced window, from the first traced request's start to
the last one's end, in which no device operation (kernel, copy, set, or a
replay of the captured postprocess graph, timed by CUDA events) ran."""


def read(run):
    if run.device_trace is None:
        return None
    busy, _ = run.device_trace.busy()
    lo, hi = run.device_trace.window()
    return 100.0 * (1.0 - busy / (hi - lo)) if busy > 0 and hi > lo else None
