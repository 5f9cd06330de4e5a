"""Seconds from the harness's start to the end of the warm-up: imports,
the kernels' build (cached in the checkout after a cell's first run),
the weights made on the device, the export at the cell's shape, the image
pool and a request for each image size in it (``traffic.Pool.warmup``; the
first captures the postprocess graph)."""


def read(run):
    return run.setup_s
