"""Tracing and profiling (the counterpart of the JAX package's
``utils/profiling.py``, there ``jax.profiler``).

- ``trace(logdir)``: a ``torch.profiler`` trace of the CPU and, where there
  is a card, its CUDA kernels, written to ``logdir/trace.json`` (Chrome
  trace format: Perfetto or ``chrome://tracing``); the profiler is yielded
  for ``key_averages()``.
- ``annotate(name)``: a ``record_function`` range in that trace, and an
  NVTX range on the card.
- ``latency_report(fn, args)``: device compute per call (a replayed CUDA
  graph on the card, ``runtime.aot.make_loop_timer``), host end to end and
  the dispatch cost of one call.
- ``save_graph(exported, path)``: an exported program's graph as text (the
  JAX ``save_hlo``).
- ``cost_analysis(fn, args)``: FLOPs counted by
  ``torch.utils.flop_counter.FlopCounterMode``, the MSDA custom ops by their
  own formula.  Bytes are not counted: PyTorch has no byte counter.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from codetr_torch.ops import msda  # noqa: F401  (registers the codetr:: ops counted below)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body; write ``logdir/trace.json`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range in profiler traces (and NVTX, on the card)."""
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


def latency_report(fn, args: Sequence[torch.Tensor], *, iterations: int = 20) -> dict:
    """The JAX report's keys: ``device_compute_ms`` (ms per call of a
    replayed CUDA graph on the card; on the CPU, eager calls on the host
    clock), ``host_e2e_ms`` (one call and the copy of its first output to
    the host), ``dispatch_ms`` (one call, no sync) and ``iterations``;
    ``device`` names where they were taken."""
    from codetr_torch.runtime.aot import device_of, device_name, host_e2e_ms, make_loop_timer

    device = device_of(args)
    run = make_loop_timer(fn, args, graph=device.type == "cuda")
    run(2)
    device_ms = run(iterations)
    e2e_ms = host_e2e_ms(fn, args)
    t0 = time.perf_counter()
    fn(*args)  # dispatch only
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "device_compute_ms": device_ms,
        "host_e2e_ms": e2e_ms,
        "dispatch_ms": dispatch_ms,
        "iterations": iterations,
        "device": device_name(device),
    }


def save_graph(exported, path: str) -> str:
    """Write an exported program's graph (``ExportedProgram`` or what
    ``compile_forward`` returned) as text."""
    program = getattr(exported, "exported", exported)
    with open(path, "w") as f:
        f.write(str(program))
    return path


def _msda_flops(value_shape, num_queries: int, taps_per_query: int) -> int:
    """4 corners x d channels x (multiply + add) per tap."""
    bs, _, h, d = value_shape
    return bs * num_queries * h * taps_per_query * 4 * d * 2


@register_flop_formula(torch.ops.codetr.msda_packed)
def _packed_flops(value_shape, cpk_shape, spatial_shapes, num_points, *args, **kwargs) -> int:
    return _msda_flops(value_shape, value_shape[1], len(spatial_shapes) // 2 * num_points)


@register_flop_formula(torch.ops.codetr.msda_reference)
def _reference_flops(value_shape, loc_shape, attn_shape, spatial_shapes, *args, **kwargs) -> int:
    return _msda_flops(value_shape, loc_shape[1], attn_shape[3] * attn_shape[4])


def cost_analysis(fn, args: Sequence[torch.Tensor]) -> dict:
    """FLOPs of one ``fn(*args)``, total and per op (``FlopCounterMode``);
    bytes are n/a.  Runs with autograd as the caller has it: the counter's
    module tracker fails on an ``nn.Module`` called under ``no_grad``."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return {
        "flops": float(counter.get_total_flops()),
        "flops_by_op": {str(k): float(v) for k, v in counter.get_flop_counts().get("Global", {}).items()},
        "bytes": None,
    }

