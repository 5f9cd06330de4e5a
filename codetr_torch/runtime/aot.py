"""Export, save, reload and device timing of the served forward: the
counterpart of the JAX package's ``runtime/aot.py`` (there ``jax.jit`` +
``jax.export``; here ``torch.export``).

- ``compile_forward(model, height=, width=, ...)`` exports the model's
  forward at one fixed shape with ``torch.export.export`` and returns
  ``(fn, example_args)``; ``fn.exported`` is the ``ExportedProgram``.  The
  MSDA kernels are ``torch.library`` custom ops (``ops/msda.py``), so the
  program holds ``codetr::msda_packed`` / ``codetr::msda_reference`` nodes
  and runs the kernels wherever it is loaded.
- ``save_executable(path, exported, example_args, meta)`` writes ``<path>``
  (``torch.export.save``, the weights inside) and ``<path>.meta.json``
  (``config``, ``dtype``, ``height``, ``width``, ``batch_size``,
  ``fused_preprocess``, ``in_avals`` and the magic ``codetr-torch-pt2-v1``).
- ``load_executable(path, device="cuda")`` checks the magic and returns a
  callable on ``device``.  An fp32 program runs under ``full_fp32()`` (no
  TF32), read from the meta's ``dtype``: the scope that an in-process fp32
  model sets around its forward leaves nothing in an exported graph.
- ``make_loop_timer(fn, args, graph=True)`` and ``benchmark(...)``: time a
  forward on the device.  On the card, ``graph=True`` captures ``fn(*args)``
  once in a ``torch.cuda.CUDAGraph`` and replays it between two CUDA events
  (the counterpart of the JAX on-device ``fori_loop``: no host dispatch in
  the timed loop); ``graph=False`` puts the events around eager calls, what
  a Python caller pays.  On the CPU (tests) only ``graph=False`` exists and
  times with ``perf_counter``.

Not carried over: the JAX ``split=True`` form (backbone and head as two
executables) and the weights-as-arguments ``.params.npz`` companion worked
around the TPU's remote compile transport, which a local ``torch.export``
does not have; the ``.stablehlo`` companion feeds the JAX package's C++
runner, whose port (libtorch / AOTInductor) is later work.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from codetr_torch.config import PreprocessConfig
from codetr_torch.models.codetr import check_device, fp32_scope
from codetr_torch.ops import msda  # registers the codetr:: ops a program calls
from codetr_torch.utils.preprocess import preprocess_in_graph

MAGIC = "codetr-torch-pt2-v1"
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_name(dtype: torch.dtype) -> str:
    return {v: k for k, v in DTYPES.items()}[dtype]


class _Forward(torch.nn.Module):
    """(batch_inputs (bs, H, W, 3), img_masks (bs, H, W)) -> the model's
    (boxes, scores, labels)."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch_inputs, img_masks):
        return self.model(batch_inputs, img_masks)


class _FusedForward(torch.nn.Module):
    """The fused-serving form: (canvas_u8 (bs, H, W, 3) uint8, thw (bs, 2)
    int32) -> normalise, pad and mask in the graph, then the model."""

    def __init__(self, model, mean, std, dtype):
        super().__init__()
        self.model, self.mean, self.std, self.dtype = model, tuple(mean), tuple(std), dtype

    def forward(self, canvas_u8, thw):
        x, m = preprocess_in_graph(canvas_u8, thw, mean=self.mean, std=self.std)
        return self.model(x.to(self.dtype), m)


class Program:
    """An exported forward as a callable: ``fn(*args)`` runs the program
    without autograd, an fp32 one under ``full_fp32()``."""

    def __init__(self, exported: torch.export.ExportedProgram, dtype: torch.dtype):
        self.exported = exported
        self.dtype = dtype
        self._module = exported.module()

    def __call__(self, *args):
        with torch.no_grad(), fp32_scope(self.dtype):
            return self._module(*args)


def compile_forward(
    model,
    *,
    height: int,
    width: int,
    batch_size: int = 1,
    dtype: Optional[torch.dtype] = None,
    fuse_preprocess: bool = False,
    preprocess_cfg: Optional[PreprocessConfig] = None,
):
    """Export the model's forward at a fixed static shape -> (fn,
    example_args), both on the model's device.  ``fn(batch_inputs (bs, H, W,
    3) dtype, img_masks (bs, H, W) float32)`` returns (boxes, scores,
    labels); with ``fuse_preprocess=True`` the calling convention is
    ``fn(canvas_u8 (bs, H, W, 3) uint8, thw (bs, 2) int32)`` and
    ``preprocess_in_graph`` runs inside the program.  ``dtype`` defaults to
    the model's."""
    dtype = model.dtype if dtype is None else dtype
    device = next(model.parameters()).device
    if fuse_preprocess:
        cfg = preprocess_cfg or PreprocessConfig()
        module = _FusedForward(model, cfg.mean, cfg.std, dtype)
        example = (
            torch.zeros(batch_size, height, width, 3, dtype=torch.uint8, device=device),
            torch.tensor([[height, width]] * batch_size, dtype=torch.int32, device=device),
        )
    else:
        module = _Forward(model)
        example = (
            torch.zeros(batch_size, height, width, 3, dtype=dtype, device=device),
            torch.zeros(batch_size, height, width, dtype=torch.float32, device=device),
        )
    with torch.no_grad():
        exported = torch.export.export(module.eval(), example, strict=False)
    return Program(on_device(exported, device), dtype), example


def on_device(exported: torch.export.ExportedProgram, device: torch.device):
    """The program with every weight and constant on ``device``.  Tracing
    keeps each ``torch.tensor(data, device=...)`` of the model (level
    shapes, scales, Swin's shift masks) as a CPU constant and a copy to the
    device per call; on the card such a host-to-device copy cannot be
    captured in a CUDA graph, so the constants move to the card once."""
    tensors = [t for t in (*exported.state_dict.values(), *exported.constants.values()) if torch.is_tensor(t)]
    if all(t.device == device for t in tensors):
        return exported
    from torch.export.passes import move_to_device_pass

    return move_to_device_pass(exported, device)


def msda_nodes(exported: torch.export.ExportedProgram) -> dict:
    """The ``codetr::`` op nodes of a program's graph, counted by op."""
    counts: dict = {}
    for node in exported.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("codetr."):
            counts[name] = counts.get(name, 0) + 1
    return counts


def save_executable(path: str, exported, example_args: Sequence[torch.Tensor],
                    meta: Optional[dict] = None) -> str:
    """Write ``<path>`` (``torch.export.save``, the weights inside) and
    ``<path>.meta.json``.  ``exported`` is an ``ExportedProgram`` or what
    ``compile_forward`` returned (whose dtype fills the meta's ``dtype``
    when ``meta`` has none; ``load_executable`` needs it)."""
    program = getattr(exported, "exported", exported)
    torch.export.save(program, path)
    meta = dict(meta or {})
    if "dtype" not in meta and hasattr(exported, "dtype"):
        meta["dtype"] = dtype_name(exported.dtype)
    meta.update(
        magic=MAGIC,
        in_avals=[[list(a.shape), str(a.dtype).replace("torch.", "")] for a in example_args],
        msda_ops=msda_nodes(program),
    )
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


def load_executable(path: str, device="cuda") -> Program:
    """Read a saved program and its meta; return it as a callable on
    ``device`` (the card by default; raises without one).  A bad or missing
    magic raises, and so does, on the card, a kernel library that cannot be
    built or loaded: the program never runs the plain MSDA there."""
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{path}: not a codetr-torch program (magic {meta.get('magic')!r}, "
                         f"expected {MAGIC!r})")
    device = check_device(device)
    exported = on_device(torch.export.load(path), device)
    if device.type == "cuda":
        msda._fwd_lib()  # build and load the forward kernels now, or raise
    return Program(exported, DTYPES[meta["dtype"]])


def device_of(args: Sequence[torch.Tensor]) -> torch.device:
    return next(a.device for a in args if torch.is_tensor(a))


class _LastOp(TorchDispatchMode):
    """Records the last op dispatched, to name the op a capture failed at."""

    def __init__(self):
        super().__init__()
        self.last = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.last = str(func)
        return func(*args, **(kwargs or {}))


def capture(fn: Callable, args: Sequence[torch.Tensor]) -> torch.cuda.CUDAGraph:
    """``fn(*args)`` captured once in a CUDA graph (after the caller's
    warm-up).  A capture that fails raises, naming the last op dispatched;
    nothing falls back to eager calls.  The graph keeps its outputs
    (``graph.outputs``) and memory pool alive."""
    graph = torch.cuda.CUDAGraph()
    seen = _LastOp()
    try:
        with torch.cuda.graph(graph):
            with seen:
                out = fn(*args)
    except RuntimeError as e:
        raise RuntimeError(f"CUDA-graph capture failed at op {seen.last}: {e}") from e
    graph.outputs = out
    return graph


def make_loop_timer(fn: Callable, args: Sequence[torch.Tensor], *, graph: bool = True,
                    warmup: int = 3) -> Callable[[int], float]:
    """-> ``run(n)``, the ms per iteration of n runs of ``fn(*args)`` with
    one host sync.  On the card, after ``warmup`` calls on a side stream:
    ``graph=True`` replays one capture n times between two CUDA events;
    ``graph=False`` records the events around n eager calls.  On the CPU,
    ``graph=False`` times n calls with ``perf_counter``; ``graph=True``
    raises.

    The JAX timer's guards against XLA hoisting the loop body or removing
    it as dead code (``_fold``, ``_perturb``) are not needed here: each
    replay of a captured graph runs every kernel it recorded."""
    device = device_of(args)
    if device.type != "cuda":
        if graph:
            raise ValueError("graph=True replays a CUDA graph: it needs the card")
        for _ in range(warmup):
            fn(*args)

        def run_cpu(n: int) -> float:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(*args)
            return (time.perf_counter() - t0) / n * 1e3

        return run_cpu

    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    if graph:
        captured = capture(fn, args)
        step = captured.replay
    else:
        def step():
            fn(*args)

    def run(n: int) -> float:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            step()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    run.graph = captured if graph else None  # type: ignore[attr-defined]
    return run


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def percentile_stats(block_ms: list) -> dict:
    a = np.asarray(block_ms, np.float64)
    return {
        "device_ms_per_iter": float(a.mean()),
        "p50_ms": float(np.percentile(a, 50)),
        "p95_ms": float(np.percentile(a, 95)),
        "min_ms": float(a.min()),
        "blocks_ms": [float(x) for x in a],
    }


def host_e2e_ms(fn: Callable, args: Sequence[torch.Tensor]) -> float:
    """Host clock around one call and the copy of its first output to the
    host."""
    t0 = time.perf_counter()
    out = fn(*args)
    first = out[0] if isinstance(out, (tuple, list)) else out
    first.cpu()
    return (time.perf_counter() - t0) * 1e3


def benchmark(fn: Callable, args: Sequence[torch.Tensor], *, iterations: int = 20,
              warmup: int = 3, blocks: int = 5, graph: bool = True) -> dict:
    """The JAX ``benchmark``'s statistics: ``blocks`` timed loops of
    ``iterations // blocks`` iterations each (``make_loop_timer``), mean,
    p50, p95 and min over the per-block ms per iteration, and one host
    end-to-end call.  ``device`` names where the numbers were taken and
    ``mode`` how."""
    run = make_loop_timer(fn, args, graph=graph, warmup=warmup)
    m = max(1, iterations // max(1, blocks))
    run(max(1, warmup))
    stats = percentile_stats([run(m) for _ in range(blocks)])
    stats["iterations"] = m * blocks
    stats["host_e2e_ms"] = host_e2e_ms(fn, args)
    device = device_of(args)
    stats["device"] = device_name(device)
    stats["mode"] = ("cuda-graph replay" if graph else "eager") + (
        ", CUDA events" if device.type == "cuda" else ", perf_counter")
    return stats
