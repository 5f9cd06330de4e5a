"""Microbenchmarks of an in-kernel gather against plane arithmetic on the
card: kernel K5's counterpart.

The port of ``tools/gatherbench.py``, the JAX package's Pallas
microbenchmarks, whose question was whether an in-core vectorised gather
could replace the windowed MSDA kernel's splat build.  Five ops, each
running ``R`` = 64 iterations inside one kernel (``csrc/gatherbench.cu``):

- ``gather_sub(x, idx)``: ``g[r, c] = x[(idx[r, c] + i) % n, c]``, a gather
  along rows (x (n, m) fp32 or bf16, idx int32);
- ``gather_lane(x, idx)``: ``g[r, c] = x[r, (idx[r, c] + i) % m]``, a
  gather along columns;
- ``idxadd(idx, n)``: ``(idx + i) % n``, the per-corner index derivation;
- ``splat2(hy, hx)``: ``(hy + i)[:, None, :] * hx[None, :, :]``, the
  windowed kernel's splat unit over (wh * ww, nq);
- ``fma1(a, b, c)``: ``a * b + (c + i)``, fused on the card.

Iteration ``i`` perturbs the inputs by ``i``, and the plane's first 8 rows
and 128 columns are summed over the iterations, in order, into an (8, 128)
fp32 checksum: the JAX ops' result.  For CPU tensors each op runs its plain
version (``*_plain``: the same 64 iterations in torch ops); for CUDA
tensors it launches its kernel, or raises.  ``launches`` counts the kernel
launches.

On the card, ``python3 -m codetr_torch.tools.gatherbench`` sweeps the JAX
script's sizes and prints one JSON object: the device, the microseconds
per op and in-kernel iteration under the JAX keys (``us_per_op``), one
PyTorch call computing the same plane (``library_us``: ``torch.gather``,
``torch.add``, the broadcast product, ``torch.addcmul``; a yardstick the
ops never call), each op's least time per iteration (``bound_us_per_op``,
see ``bound_ms``) and, before and after, a 4096^3 bf16 ``torch.matmul`` as
a health canary of the card.  Without a card it exits non-zero.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys

import numpy as np
import torch

from codetr_torch.ops import _build
from codetr_torch.ops.msda import _raise_on

R = 64  # in-kernel iterations
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# H100 SXM rates at the 700 W limit: HBM and fp32 outside the tensor cores
# (NVIDIA data sheet); shared memory 128 bytes a clock per SM (32 banks of
# 4 bytes) x 132 SMs x the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_SMEM_BYTES_PER_S = 128 * 132 * 1.98e9
PEAK_FP32_OPS = 67e12
# 32-bit operations per plane element and iteration in the kernels: the
# fold's add; idxadd's index add; splat2's perturbing add and product;
# fma1's perturbing add and fused multiply-add (two)
OPS_PER_ELEMENT = {"gather_sub": 1, "gather_lane": 1, "idxadd": 2, "splat2": 3, "fma1": 4}


def _fold(acc: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    return acc + plane[:8, :128].float()


def _zeros(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros(8, 128, dtype=torch.float32, device=t.device)


def gather_sub_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    n, acc = x.shape[0], _zeros(x)
    for i in range(R):
        acc = _fold(acc, torch.gather(x, 0, ((idx + i) % n).long()))
    return acc


def gather_lane_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    m, acc = x.shape[1], _zeros(x)
    for i in range(R):
        acc = _fold(acc, torch.gather(x, 1, ((idx + i) % m).long()))
    return acc


def idxadd_plain(idx: torch.Tensor, n: int) -> torch.Tensor:
    acc = _zeros(idx)
    for i in range(R):
        acc = _fold(acc, (idx + i) % n)
    return acc


def splat2_plain(hy: torch.Tensor, hx: torch.Tensor) -> torch.Tensor:
    (wh, nq), ww, acc = hy.shape, hx.shape[0], _zeros(hy)
    for i in range(R):
        acc = _fold(acc, ((hy + i)[:, None, :] * hx[None, :, :]).reshape(wh * ww, nq))
    return acc


def fma1_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    acc = _zeros(a)
    for i in range(R):
        acc = _fold(acc, a * b + (c + i))
    return acc


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built K5 library, with its C signatures declared."""
    lib = _build.load("gatherbench").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {
        "gb_gather_sub": [p, p, p, p, i, i, i, i, p],
        "gb_gather_lane": [p, p, p, p, i, i, i, p],
        "gb_idxadd": [p, p, p, i, i, i, p],
        "gb_splat2": [p, p, p, p, i, i, i, i, p],
        "gb_fma1": [p, p, p, p, p, i, i, i, p],
    }
    for name, args in sigs.items():
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = i
    return lib


def _launch(fn: str, tensors, ints, plane_hw) -> torch.Tensor:
    """Launch ``fn`` on ``tensors`` (contiguous, one card) and the int
    arguments, into a fresh (8, 128) checksum."""
    global launches
    dev = tensors[0].device
    if plane_hw[0] < 8 or plane_hw[1] < 128:
        raise ValueError(f"the checksum folds an (8, 128) corner; the plane is {plane_hw}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors on one card")
    checksum = torch.empty(8, 128, dtype=torch.float32, device=dev)
    sink = torch.empty(1, dtype=torch.float32, device=dev)  # never written
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(_lib(), fn)(*(t.data_ptr() for t in tensors), checksum.data_ptr(),
                                  sink.data_ptr(), *ints, stream)
    _raise_on(err, fn)
    launches += 1
    return checksum


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"gatherbench runs on CPU (plain version) or CUDA (kernel), not {t.device}")


def _check_gather(x, idx):
    if x.dim() != 2 or idx.shape != x.shape or idx.dtype != torch.int32:
        raise ValueError(f"x (n, m) and int32 idx of its shape, got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)} {idx.dtype}")


def gather_sub(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_gather(x, idx)
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if _route(x) == "cpu":
        return gather_sub_plain(x, idx)
    n, m = x.shape
    return _launch("gb_gather_sub", (x, idx), (_DTYPE_CODE[x.dtype], n, m, R), (n, m))


def gather_lane(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_gather(x, idx)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if _route(x) == "cpu":
        return gather_lane_plain(x, idx)
    n, m = x.shape
    return _launch("gb_gather_lane", (x, idx), (n, m, R), (n, m))


def idxadd(idx: torch.Tensor, n: int) -> torch.Tensor:
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 (n, m), got {tuple(idx.shape)} {idx.dtype}")
    if _route(idx) == "cpu":
        return idxadd_plain(idx, n)
    return _launch("gb_idxadd", (idx,), (n, idx.shape[1], R), tuple(idx.shape))


def splat2(hy: torch.Tensor, hx: torch.Tensor) -> torch.Tensor:
    if hy.dim() != 2 or hx.dim() != 2 or hy.shape[1] != hx.shape[1] or {hy.dtype, hx.dtype} != {torch.float32}:
        raise ValueError(f"hy (wh, nq) and hx (ww, nq) float32, got {tuple(hy.shape)}, {tuple(hx.shape)}")
    if _route(hy) == "cpu":
        return splat2_plain(hy, hx)
    (wh, nq), ww = hy.shape, hx.shape[0]
    return _launch("gb_splat2", (hy, hx), (wh, ww, nq, R), (wh * ww, nq))


def fma1(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    if a.dim() != 2 or not a.shape == b.shape == c.shape or {a.dtype, b.dtype, c.dtype} != {torch.float32}:
        raise ValueError("a, b and c must be float32 planes of one shape")
    if _route(a) == "cpu":
        return fma1_plain(a, b, c)
    n, m = a.shape
    return _launch("gb_fma1", (a, b, c), (n, m, R), (n, m))


KERNEL = {"gather_sub": gather_sub, "gather_lane": gather_lane, "idxadd": idxadd,
          "splat2": splat2, "fma1": fma1}
PLAIN = {"gather_sub": gather_sub_plain, "gather_lane": gather_lane_plain,
         "idxadd": idxadd_plain, "splat2": splat2_plain, "fma1": fma1_plain}


def make_inputs(op: str, size, dtype=torch.float32, device="cuda", seed: int = 1):
    """Seeded inputs of ``op`` at ``size`` ((n, m), or (wh, ww, nq) for
    splat2): normal planes, uniform indices in range."""
    rng = np.random.default_rng(seed)
    if op == "splat2":
        wh, ww, nq = size
        planes = (rng.standard_normal((wh, nq)), rng.standard_normal((ww, nq)))
        return tuple(torch.from_numpy(p.astype(np.float32)).to(device) for p in planes)
    n, m = size
    if op == "fma1":
        return tuple(torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32)).to(device)
                     for _ in range(3))
    idx = torch.from_numpy(rng.integers(0, m if op == "gather_lane" else n, (n, m)).astype(np.int32))
    if op == "idxadd":
        return idx.to(device), n
    x = torch.from_numpy(rng.standard_normal((n, m)).astype(np.float32))
    return x.to(device, dtype), idx.to(device)


def cases():
    """(key, op, size, dtype) of the JAX script's sweep, its keys and order."""
    out = []
    for n in (256, 704, 1040):
        m = 256
        for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
            out.append((f"gather_sub_{n}x{m}_{name}", "gather_sub", (n, m), dt))
            if dt == torch.float32:
                out.append((f"gather_lane_{n}x{m}_{name}", "gather_lane", (n, m), dt))
        out.append((f"idxadd_{n}x{m}", "idxadd", (n, m), torch.int32))
    for geom in ((26, 40, 256), (22, 32, 256), (8, 128, 256)):
        out.append((f"splat2_{geom[0]}x{geom[1]}x{geom[2]}_float32", "splat2", geom, torch.float32))
    out.append(("fma1_1040x256_f32", "fma1", (1040, 256), torch.float32))
    return out


def library_plane(op: str, inputs):
    """One PyTorch call computing one iteration's plane of ``op``."""
    if op in ("gather_sub", "gather_lane"):
        x, idx = inputs[0], inputs[1].long()
        return functools.partial(torch.gather, x, 0 if op == "gather_sub" else 1, idx)
    if op == "idxadd":
        return functools.partial(torch.add, inputs[0], 1)
    if op == "splat2":
        hy, hx = inputs
        return functools.partial(torch.mul, hy[:, None, :], hx[None, :, :])
    a, b, c = inputs
    return functools.partial(torch.addcmul, c, a, b)


def bound_ms(op: str, size, dtype) -> tuple:
    """Least time for one call of ``op`` -> (ms, "bytes" | "operations"):
    the larger of the inputs read once and the checksum written once over
    HBM's rate, the gathers' shared-memory reads (one element per plane
    element and iteration) over that rate, and the 32-bit operations over
    the fp32 rate."""
    elt = torch.empty((), dtype=dtype).element_size()
    if op == "splat2":
        wh, ww, nq = size
        elements, hbm = wh * ww * nq, (wh + ww) * nq * 4
    else:
        n, m = size
        elements = n * m
        hbm = {"idxadd": 4, "fma1": 12}.get(op, elt + 4) * elements
    hbm += 8 * 128 * 4
    smem = elements * R * elt if op.startswith("gather") else 0
    t_bytes = max(hbm / PEAK_BYTES_PER_S, smem / PEAK_SMEM_BYTES_PER_S) * 1e3
    t_ops = elements * R * OPS_PER_ELEMENT[op] / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


HOLD_CYCLES = 20_000_000  # ~10 ms of the card's clock


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls.  These
    kernels take microseconds, less than the host takes to enqueue a call,
    so the card is first held busy (``torch.cuda._sleep``) while the host
    queues all the calls: the events then time the device's work, not the
    host's enqueue rate."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep(reps: int = 20):
    """Each case on the card -> {key: {"ms": kernel ms per call, "us_per_op":
    us per in-kernel iteration, "plain_ms": the plain version's ms per call,
    "library_us": us per plane of one PyTorch call, "bound_ms", "bound_by"}}."""
    results = {}
    for key, op, size, dtype in cases():
        inputs = make_inputs(op, size, dtype)
        ms = cuda_ms(functools.partial(KERNEL[op], *inputs), reps)
        b_ms, b_by = bound_ms(op, size, dtype)
        results[key] = {"ms": ms, "us_per_op": ms * 1e3 / R,
                        "plain_ms": cuda_ms(functools.partial(PLAIN[op], *inputs), 2, warmup=1),
                        "library_us": cuda_ms(library_plane(op, inputs), reps) * 1e3,
                        "bound_ms": b_ms, "bound_by": b_by}
    return results


def canary_ms() -> float:
    """One 4096^3 bf16 ``torch.matmul`` on the card, ms: a health check of
    its tensor cores, as the JAX script's canary."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(4096, 4096, generator=gen, device="cuda", dtype=torch.bfloat16)
    return cuda_ms(lambda: torch.matmul(a, a), 5)


def main() -> int:
    if not torch.cuda.is_available():
        print("gatherbench: no CUDA device; the microbenchmarks run on the card", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0), "canary_matmul_ms": canary_ms()}
    results = sweep()
    out["us_per_op"] = {k: r["us_per_op"] for k, r in results.items()}
    out["library_us"] = {k: r["library_us"] for k, r in results.items()}
    out["bound_us_per_op"] = {k: r["bound_ms"] * 1e3 / R for k, r in results.items()}
    out["canary_matmul_ms_after"] = canary_ms()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
