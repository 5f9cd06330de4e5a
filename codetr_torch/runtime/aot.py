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
- ``save_package(path, program, example_args, meta, device="cuda")``
  compiles an exported forward ahead of time with AOTInductor
  (``torch._inductor.aoti_compile_and_package``) for ``device`` and writes
  ``<path>.aoti.pt2`` (generated code, kernels and weights) and
  ``<path>.aoti.pt2.meta.json`` (magic ``codetr-torch-aoti-v1``);
  ``load_package(path, device="cuda")`` returns it as a callable like
  ``Program``'s.  The package calls the two MSDA ops by name through the
  dispatcher: in a process that imported ``ops/msda.py``, its Python
  registrations (counters and all); in one that loaded
  ``csrc/msda_ops.cpp``'s library instead, the C++ ones
  (``tools/aoti_run.py``), with no Python kernel code.
- ``make_loop_timer(fn, args, graph=True)`` and ``benchmark(...)``: time a
  forward on the device.  On the card, ``graph=True`` captures ``fn(*args)``
  once in a ``torch.cuda.CUDAGraph`` and replays it between two CUDA events
  (the counterpart of the JAX on-device ``fori_loop``: no host dispatch in
  the timed loop); ``graph=False`` puts the events around eager calls, what
  a Python caller pays.  On the CPU (tests) only ``graph=False`` exists and
  times with ``perf_counter``.
- ``Replay(fn, args)``: ``fn`` captured once on the card over static copies
  of ``args`` and replayed on each call (the ``Inferencer``'s postprocess,
  the counterpart of the JAX ``jax.jit(postprocess_detections)``; the train
  step's, ``parallel/train.py:capture_train_step``); ``pool_bytes(graph)``
  the memory its graph holds.  Keep ``torch.cuda.empty_cache()`` away from
  a captured train step while it lives: called between trainbench's capture
  of the bf16 Swin-L step and its first replay, the replay crashed the
  process (a segmentation fault in ``cudaGraphLaunch``), after two earlier
  graphs of the same model had been captured and dropped; the cause is not
  known (a small graph of GEMMs and their backward does not show it).

Not carried over: the JAX ``split=True`` form (backbone and head as two
executables) and the weights-as-arguments ``.params.npz`` companion worked
around the TPU's remote compile transport, which a local ``torch.export``
does not have.  The ``.stablehlo`` companion that feeds the JAX package's
C++ runner has the AOTInductor package as its counterpart, and that runner
``csrc/codetr_aoti_runner.cpp`` (``ops/_build.py:build_runner``), which
loads a package and the op library with no Python in its process.
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
PACKAGE_MAGIC = "codetr-torch-aoti-v1"
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


def _read_meta(path: str, magic: str) -> dict:
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("magic") != magic:
        raise ValueError(f"{path}: not a codetr-torch program (magic {meta.get('magic')!r}, "
                         f"expected {magic!r})")
    return meta


def load_executable(path: str, device="cuda") -> Program:
    """Read a saved program and its meta; return it as a callable on
    ``device`` (the card by default; raises without one).  A bad or missing
    magic raises, and so does, on the card, a kernel library that cannot be
    built or loaded: the program never runs the plain MSDA there."""
    meta = _read_meta(path, MAGIC)
    device = check_device(device)
    exported = on_device(torch.export.load(path), device)
    if device.type == "cuda":
        msda._fwd_lib()  # build and load the forward kernels now, or raise
    return Program(exported, DTYPES[meta["dtype"]])


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``: a traced program's device checks
    compare devices with their index."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def package_dtype(meta: dict, example_args: Sequence[torch.Tensor]) -> torch.dtype:
    """The compute dtype of a package, the meta's ``dtype``; it must be one
    of ``DTYPES`` and, for the plain form, the image input's dtype: the
    native runner casts the image to ``in_avals``' dtype and sets its
    precision (TF32 off for float32) by ``dtype``, so a package whose two
    disagree would run in a precision its meta does not say.  Raises
    ``ValueError`` otherwise."""
    name = meta.get("dtype")
    if name not in DTYPES:
        raise ValueError(f"a package computes in one of {sorted(DTYPES)}, the meta says {name!r}")
    image = example_args[0].dtype if example_args else None
    if image not in (None, torch.uint8, DTYPES[name]):
        raise ValueError(f"the meta's dtype {name} is not the program's image dtype "
                         f"{str(image).replace('torch.', '')}")
    return DTYPES[name]


def save_package(path: str, program, example_args: Sequence[torch.Tensor], meta: Optional[dict] = None,
                 device="cuda") -> str:
    """Compile ``program`` (what ``compile_forward`` returned, or an
    ``ExportedProgram``) with AOTInductor for ``device`` (the card by
    default) and write the package, ``<path>.aoti.pt2``, and its meta;
    -> the package's path.  The compile runs under the program's precision
    scope (``fp32_scope``), and the meta's ``dtype`` (from ``program`` when
    ``meta`` has none) makes ``load_package`` run it there too: Inductor's
    extern GEMMs and convolutions read the TF32 flags when they run.  A
    bf16 program compiles and runs as it is (``fp32_scope`` is no scope
    there); ``package_dtype`` refuses a meta whose dtype is not the
    program's.
    The wrapper is built by the ``g++`` on the path, the host compiler that
    nvcc builds the port's libraries with, not by ``$CXX`` (Inductor's
    default), which may name a compiler without OpenMP's runtime, and the
    wrapper links with ``-fopenmp``."""
    device = _indexed(check_device(device))
    meta = dict(meta or {})
    if "dtype" not in meta and hasattr(program, "dtype"):
        meta["dtype"] = dtype_name(program.dtype)
    dtype = package_dtype(meta, example_args)
    exported = on_device(getattr(program, "exported", program), device)
    path += ".aoti.pt2"
    from torch._inductor import aoti_compile_and_package

    with torch.no_grad(), fp32_scope(dtype):
        aoti_compile_and_package(exported, package_path=path, inductor_configs={"cpp.cxx": "g++"})
    meta.update(
        magic=PACKAGE_MAGIC,
        device=device.type,
        in_avals=[[list(a.shape), str(a.dtype).replace("torch.", "")] for a in example_args],
        msda_ops=msda_nodes(exported),
    )
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f, indent=2)
    return path


class Package:
    """An AOTInductor package as a callable: ``fn(*args)`` -> the forward's
    outputs as a tuple, without autograd, an fp32 package under
    ``full_fp32()`` (as ``Program``)."""

    def __init__(self, compiled, dtype: torch.dtype):
        self.compiled = compiled
        self.dtype = dtype

    def __call__(self, *args):
        with torch.no_grad(), fp32_scope(self.dtype):
            return tuple(self.compiled(*args))


def load_package(path: str, device="cuda") -> Package:
    """Read a package written by ``save_package`` (``<name>.aoti.pt2``) and
    its meta; return it as a callable on ``device`` (the card by default;
    raises without one).  A bad or missing magic raises, and so does a
    package compiled for another device type, or, on the card, a kernel
    library that cannot be built or loaded."""
    meta = _read_meta(path, PACKAGE_MAGIC)
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"{path}: a package computes in one of {sorted(DTYPES)}, the meta says "
                         f"{meta.get('dtype')!r}")
    device = _indexed(check_device(device))
    if meta.get("device") != device.type:
        raise ValueError(f"{path} was compiled for {meta.get('device')!r}, not {device.type!r}")
    if device.type == "cuda":
        msda._fwd_lib()  # build and load the forward kernels now, or raise
    index = -1 if device.index is None else device.index
    from torch._inductor import aoti_load_package

    # run_single_threaded: no per-run CUDA event and no query of the last
    # run's, which a CUDA-graph capture of a call would refuse
    compiled = aoti_load_package(path, run_single_threaded=True, device_index=index)
    return Package(compiled, DTYPES[meta["dtype"]])


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


def warm_up(fn: Callable, args: Sequence[torch.Tensor], n: int) -> None:
    """``n`` calls of ``fn(*args)`` on a side stream of the card (what a
    capture needs done first: library handles, workspaces), then a sync."""
    device = device_of(args)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(n):
            fn(*args)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


class Replay:
    """``fn`` captured once in a CUDA graph over static copies of ``args``
    (after ``warmup`` calls); each call copies its arguments in, replays the
    graph and returns clones of its outputs, since the next replay
    overwrites the graph's own.  The arguments must have the shapes and
    dtypes of the captured ones.  A capture that fails raises (``capture``);
    ``calls`` counts the replays."""

    def __init__(self, fn: Callable, args: Sequence[torch.Tensor], warmup: int = 1):
        if device_of(args).type != "cuda":
            raise ValueError("Replay captures a CUDA graph: it needs the card")
        self.inputs = [a.clone() for a in args]
        warm_up(fn, self.inputs, warmup)
        self.graph = capture(fn, self.inputs)
        self.calls = 0

    def __call__(self, *args: torch.Tensor):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        self.calls += 1
        return tuple(t.clone() for t in self.graph.outputs)


def pool_bytes(graph: torch.cuda.CUDAGraph) -> int:
    """The bytes of ``graph``'s private memory pool: the card's memory that a
    captured graph holds for as long as it lives, beside the tensors made
    before the capture."""
    pool = tuple(graph.pool())
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == pool)


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

    warm_up(fn, args, warmup)
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
