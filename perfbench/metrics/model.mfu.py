"""The forward's share (%) of the card's published dense peak in the
configuration's dtype: FLOPs of one image counted on the benchmark's own
reference (``perfbench/costs.py:forward_flops``) over ``forward.device_ms``.
Nothing without a trace or for a card ``peaks.json`` does not list."""

from perfbench import costs


def read(run):
    peak = costs.peaks(run.card)
    if run.trace is None or peak is None:
        return None
    ops = run.trace.launched_in("forward")
    if not ops:
        return None
    seconds = sum(op.dur for op in ops) / 1e6 / run.traced_images
    flops = costs.forward_flops(run.cell.config, run.canvas)
    return 100.0 * flops / seconds / peak["flops"][run.cell.config["dtype"]]
