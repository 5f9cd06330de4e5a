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
see ``bound_ms``), the launch floor of each case (``floor_us``: the empty
kernel ``gb_null`` at the case's launch geometry, through the same
``_launch``), the gathers' shared-memory wavefront figure
(``smem_wavefront_us``, see ``smem_wavefronts``) and, before and after, a
4096^3 bf16 ``torch.matmul`` as a health canary of the card.  With
``--sass [LIBRARY]`` it prints instead, for each kernel of a built K5
library (default: this tree's), its ``I2F`` instructions and how many of
them sit inside a loop (``cuobjdump -sass``).  Without a card it exits
non-zero.

The launch geometry of the two gathers is a host-side plan
(``gather_sub_plan``, ``gather_lane_plan``) that the C entries take as
ints; ``assignments`` replays the kernels' thread-to-element mapping on
the host, so that the CPU tests can check it covers each plane element
once.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from codetr_torch.ops import _build
from codetr_torch.ops.msda import _raise_on

R = 64  # in-kernel iterations
launches = 0
launches_by_entry = collections.Counter()  # the same launches by C entry

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# H100 SXM rates at the 700 W limit: HBM and fp32 outside the tensor cores
# (NVIDIA data sheet); shared memory 128 bytes a clock per SM (32 banks of
# 4 bytes) x 132 SMs x the 1.98 GHz boost clock
PEAK_BYTES_PER_S = 3.35e12
PEAK_SMEM_BYTES_PER_S = 128 * 132 * 1.98e9
PEAK_FP32_OPS = 67e12
NUM_SMS, CLOCK_HZ = 132, 1.98e9
# 32-bit operations per plane element and iteration in the kernels: the
# fold's add; idxadd's index add; splat2's perturbing add and product;
# fma1's perturbing add and fused multiply-add (two)
OPS_PER_ELEMENT = {"gather_sub": 1, "gather_lane": 1, "idxadd": 2, "splat2": 3, "fma1": 4}


# launch geometry; the kernels' own constants in csrc/gatherbench.cu
SMEM_LIMIT = 232448  # bytes of shared memory a block may use (227 KB)
THREADS = 256  # the elementwise ops' block (GB_THREADS)
ROW_BYTES = 128  # gather_sub: one stripe row, 32 fp32 or 64 bf16 columns
SUB_STATIC = 16  # gather_sub: static shared memory (its mbarrier)
SUB_WARPS = 16  # gather_sub: warps a block
SUB_CLUSTER = 2  # gather_sub: blocks a cluster shares one stripe copy among (a TPC's two SMs)
SUB_MAX_N = (SMEM_LIMIT - SUB_STATIC) // ROW_BYTES - (R - 1)  # the stripe's n + R - 1 rows fit
LANE_MAX_WARPS = 32  # gather_lane: warps a block (one block a row)


class SubPlan(NamedTuple):
    """gather_sub's grid: (groups, stripes) blocks of ``warps`` warps, in
    clusters of ``cluster`` along the groups; block (g, s) holds stripe s's
    ``cols`` columns over n + R - 1 rows (``smem`` bytes) and computes rows
    [g * rows, (g + 1) * rows)."""

    cols: int
    stripes: int
    groups: int
    rows: int
    cluster: int
    warps: int
    smem: int


def gather_sub_plan(n: int, m: int, dtype) -> SubPlan:
    """About one block an SM: ``NUM_SMS // stripes`` row groups a stripe,
    rounded down to whole clusters (at least one), and no more groups than
    rows; raises ``ValueError`` past ``SUB_MAX_N``."""
    if not 1 <= n <= SUB_MAX_N:
        raise ValueError(f"gather_sub's kernel takes 1 <= n <= {SUB_MAX_N} (a stripe of n + {R - 1} "
                         f"rows of {ROW_BYTES} bytes in {SMEM_LIMIT} of shared memory), got {n}")
    cols = ROW_BYTES // torch.empty((), dtype=dtype).element_size()
    stripes = -(-m // cols)
    groups = max(1, NUM_SMS // stripes // SUB_CLUSTER) * SUB_CLUSTER
    groups = min(groups, -(-n // SUB_CLUSTER) * SUB_CLUSTER)
    return SubPlan(cols, stripes, groups, -(-n // groups), SUB_CLUSTER, SUB_WARPS,
                   (n + R - 1) * ROW_BYTES)


class LanePlan(NamedTuple):
    """gather_lane's grid: one block a row (``blocks`` = n) of ``warps``
    warps, lane l of warp q on column 32 q + l (and every 32 * warps
    further), the row's ``row_words`` words (m + R - 1) in shared memory."""

    blocks: int
    warps: int
    row_words: int
    smem: int


def gather_lane_plan(n: int, m: int) -> LanePlan:
    """A warp for every 32 columns, at most ``LANE_MAX_WARPS``."""
    if m < R - 1:
        raise ValueError(f"gather_lane's kernel repeats a row's first {R - 1} words after it: "
                         f"m = {m} is too narrow")
    if (m + R - 1) * 4 > SMEM_LIMIT:
        raise ValueError(f"gather_lane's kernel holds a row of m + {R - 1} words in shared "
                         f"memory: m = {m} is too wide")
    return LanePlan(n, min(LANE_MAX_WARPS, -(-m // 32)), m + R - 1, (m + R - 1) * 4)


def launch_geometry(op: str, size, dtype) -> tuple:
    """(blocks, threads a block, dynamic shared-memory bytes) of ``op``'s
    launch at ``size``: what the launch floor ``gb_null`` copies."""
    if op == "gather_sub":
        p = gather_sub_plan(*size, dtype)
        return p.groups * p.stripes, 32 * p.warps, p.smem
    if op == "gather_lane":
        p = gather_lane_plan(*size)
        return p.blocks, 32 * p.warps, p.smem
    rows, m = (size[0] * size[1], size[2]) if op == "splat2" else size
    return rows * -(-m // THREADS), THREADS, 0


def assignments(op: str, size, dtype=torch.float32):
    """The kernel's thread-to-element mapping replayed on the host ->
    (thread, row, col) int arrays, one entry for each element some thread
    computes; ``thread`` numbers threads across the grid."""
    out = []
    lane = np.arange(32)
    if op == "gather_sub":
        n, m = size
        p = gather_sub_plan(n, m, dtype)
        per = p.cols // 32
        for gy in range(p.stripes):
            for gx in range(p.groups):
                first = (gy * p.groups + gx) * 32 * p.warps
                r_begin, r_end = gx * p.rows, min(n, (gx + 1) * p.rows)
                for warp in range(p.warps):
                    for r in range(r_begin + warp, r_end, p.warps):
                        for q in range(per):
                            col = gy * p.cols + lane * per + q
                            ok = col < m
                            out.append((first + warp * 32 + lane[ok], np.full(ok.sum(), r), col[ok]))
    elif op == "gather_lane":
        n, m = size
        p = gather_lane_plan(n, m)
        t = np.arange(32 * p.warps)
        for r in range(n):
            for c0 in range(0, m, 32 * p.warps):
                col = c0 + t
                ok = col < m
                out.append((r * 32 * p.warps + t[ok], np.full(ok.sum(), r), col[ok]))
    else:
        rows, m = (size[0] * size[1], size[2]) if op == "splat2" else size
        bx = -(-m // THREADS)
        t = np.arange(THREADS)
        for by in range(rows):
            for x in range(bx):
                col = x * THREADS + t
                ok = col < m
                out.append(((by * bx + x) * THREADS + t[ok], np.full(ok.sum(), by), col[ok]))
    return tuple(np.concatenate([o[i] for o in out]) for i in range(3))


class Wavefronts(NamedTuple):
    """Shared-memory wavefronts of one call: ``reads`` warp-wide reads,
    ``wavefronts`` in all, ``ms`` at one wavefront a clock on each SM."""

    reads: int
    wavefronts: int
    ms: float


def _max_words_per_bank(words: np.ndarray, live: np.ndarray) -> np.ndarray:
    """For each warp-wide read (row of ``words``, 4-byte word addresses of
    the 32 lanes, ``live`` the lanes that read): the largest number of
    distinct words in one of the 32 banks."""
    w = np.sort(np.where(live, words, -1), axis=1)
    first = (w >= 0) & np.concatenate([np.ones((len(w), 1), bool), w[:, 1:] != w[:, :-1]], axis=1)
    counts = np.zeros((len(w), 32), np.int64)
    rows = np.broadcast_to(np.arange(len(w))[:, None], w.shape)
    np.add.at(counts, (rows[first], w[first] % 32), 1)
    return counts.max(axis=1)


def _warp_reads(op: str, idx: np.ndarray, dtype=torch.float32):
    """The word addresses of iteration 0's warp-wide shared-memory reads in
    ``op``'s kernel for these indices -> (words (reads, 32), live)."""
    n, m = idx.shape
    lane = np.arange(32)
    if op == "gather_sub":
        p = gather_sub_plan(n, m, dtype)
        per, elt = p.cols // 32, ROW_BYTES // p.cols
        words, live = [], []
        for s in range(p.stripes):
            for q in range(per):
                col = s * p.cols + lane * per + q  # (32,)
                ok = col < m
                j = np.where(ok, np.mod(idx[:, np.minimum(col, m - 1)], n), 0)  # (n, 32)
                words.append((j * ROW_BYTES + (lane * per + q) * elt) // 4)
                live.append(np.ones_like(j, bool))  # every lane reads, past the edge a zero
        return np.concatenate(words), np.concatenate(live)
    if op == "gather_lane":
        words, live = [], []
        for c0 in range(0, m, 32):  # a warp's 32 columns of one row, its block's only
            col = c0 + lane
            ok = np.broadcast_to(col < m, (n, 32))
            words.append(np.where(ok, np.mod(idx[:, np.minimum(col, m - 1)], m), 0))
            live.append(ok)
        return np.concatenate(words), np.concatenate(live)
    raise ValueError(f"{op} reads no shared memory")


def smem_wavefronts(op: str, idx, dtype=torch.float32) -> Wavefronts:
    """The shared-memory wavefronts ``op``'s kernel needs for ``idx``:
    over every warp-wide read, the largest number of distinct words in one
    bank, summed; and the time that takes at one wavefront a clock on each
    of the card's SMs.  Iteration i reads iteration 0's words shifted by a
    whole row (gather_sub) or by i words (gather_lane), which moves every
    lane's bank alike, so iteration 0's count is counted R times."""
    idx = idx.cpu().numpy() if isinstance(idx, torch.Tensor) else np.asarray(idx)
    words, live = _warp_reads(op, idx.astype(np.int64), dtype)
    reads = R * int(live.any(axis=1).sum())
    wavefronts = R * int(_max_words_per_bank(words, live).sum())
    return Wavefronts(reads, wavefronts, wavefronts / (NUM_SMS * CLOCK_HZ) * 1e3)


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
        "gb_gather_sub": [p, p, p, p, i, i, i, i, i, i, i, i, p],
        "gb_gather_sub_max_clusters": [i, i, i, i, i, i],
        "gb_gather_lane": [p, p, p, p, i, i, i, i, p],
        "gb_idxadd": [p, p, p, i, i, i, i, p],
        "gb_splat2": [p, p, p, p, i, i, i, i, p],
        "gb_fma1": [p, p, p, p, p, i, i, i, p],
        "gb_null": [p, p, p, i, i, i, p],
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
    launches_by_entry[fn] += 1
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
    p = gather_sub_plan(n, m, x.dtype)
    return _launch("gb_gather_sub", (x, idx),
                   (_DTYPE_CODE[x.dtype], n, m, R, p.groups, p.rows, p.cluster, p.warps), (n, m))


def gather_lane(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    _check_gather(x, idx)
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if _route(x) == "cpu":
        return gather_lane_plain(x, idx)
    n, m = x.shape
    return _launch("gb_gather_lane", (x, idx), (n, m, R, gather_lane_plan(n, m).warps), (n, m))


def idxadd(idx: torch.Tensor, n: int) -> torch.Tensor:
    if idx.dim() != 2 or idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 (n, m), got {tuple(idx.shape)} {idx.dtype}")
    if _route(idx) == "cpu":
        return idxadd_plain(idx, n)
    if n < 1 or (n - 1) * R >= 2**24:
        raise ValueError(f"idxadd's kernel sums the indices in int32, equal to the fp32 sum while "
                         f"(n - 1) * R < 2**24; got n = {n}")
    return _launch("gb_idxadd", (idx,), (*idx.shape, n, R), tuple(idx.shape))


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


def null(like: torch.Tensor, blocks: int, threads: int, smem: int = 0) -> torch.Tensor:
    """The launch floor: an empty kernel of ``blocks`` x ``threads`` with
    ``smem`` bytes of shared memory, launched as the ops are, on ``like``'s
    card (its checksum is left unwritten); on the CPU, zeros."""
    if _route(like) == "cpu":
        return _zeros(like)
    return _launch("gb_null", (like,), (blocks, threads, smem), (8, 128))


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


# sizes the sweep never reaches: ragged stripes, rows and blocks, odd
# widths, n below R (the gathers wrap more than once)
TAIL_CASES = [
    *((op, size, dt) for op in ("gather_sub", "gather_lane")
      for size in ((8, 128), (257, 130), (1041, 300))
      for dt in (torch.float32, torch.bfloat16) if not (op == "gather_lane" and dt == torch.bfloat16)),
    ("splat2", (7, 9, 130), torch.float32),
    ("idxadd", (9, 129), torch.int32),
    ("fma1", (9, 129), torch.float32),
]


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
    us per in-kernel iteration, "floor_ms": the empty kernel's ms per call at
    the case's launch geometry, "plain_ms": the plain version's ms per call,
    "library_us": us per plane of one PyTorch call, "bound_ms", "bound_by"}};
    the gathers add "smem_wavefront_ms" and "wavefronts_per_read" (see
    ``smem_wavefronts``).  Each case's floor is timed just before its
    kernel."""
    results = {}
    for key, op, size, dtype in cases():
        inputs = make_inputs(op, size, dtype)
        floor = cuda_ms(functools.partial(null, inputs[0], *launch_geometry(op, size, dtype)), reps)
        ms = cuda_ms(functools.partial(KERNEL[op], *inputs), reps)
        b_ms, b_by = bound_ms(op, size, dtype)
        r = results[key] = {"ms": ms, "us_per_op": ms * 1e3 / R, "floor_ms": floor,
                            "plain_ms": cuda_ms(functools.partial(PLAIN[op], *inputs), 2, warmup=1),
                            "library_us": cuda_ms(library_plane(op, inputs), reps) * 1e3,
                            "bound_ms": b_ms, "bound_by": b_by}
        if op.startswith("gather"):
            wf = smem_wavefronts(op, inputs[1], dtype)
            r["smem_wavefront_ms"], r["wavefronts_per_read"] = wf.ms, wf.wavefronts / wf.reads
    return results


CONFLICT_WAYS = (1, 2, 4, 8)


def conflict_indices(ways: int, n: int = 1040, m: int = 256, device="cuda") -> torch.Tensor:
    """gather_lane indices under which every warp-wide read puts ``ways``
    distinct words in each bank it touches: lane l reads word
    l // ways + 32 * (l % ways) (+ i) of its row."""
    lane = torch.arange(m) % 32
    words = lane // ways + 32 * (lane % ways)
    if int(words.max()) >= m:
        raise ValueError(f"{ways}-way conflicts need rows of more than {int(words.max())} words")
    return words.to(torch.int32).expand(n, m).contiguous().to(device)


def conflict_sweep(reps: int = 20, n: int = 1040, m: int = 256) -> dict:
    """gather_lane at (n, m) with 1-, 2-, 4- and 8-way bank conflicts on the
    card -> {ways: {"ms", "floor_ms", "smem_wavefront_ms"}}: what a
    conflict-free warp-wide read and each further wavefront cost, beside
    the one-wavefront-a-clock figure."""
    x, _ = make_inputs("gather_lane", (n, m))
    floor = cuda_ms(functools.partial(null, x, *launch_geometry("gather_lane", (n, m), torch.float32)), reps)
    out = {}
    for ways in CONFLICT_WAYS:
        idx = conflict_indices(ways, n, m)
        out[ways] = {"ms": cuda_ms(functools.partial(gather_lane, x, idx), reps), "floor_ms": floor,
                     "smem_wavefront_ms": smem_wavefronts("gather_lane", idx).ms}
    return out


def max_clusters(n: int, m: int, dtype) -> int:
    """How many of gather_sub's clusters (its plan at (n, m)) the card holds
    at once (``cudaOccupancyMaxActiveClusters``)."""
    p = gather_sub_plan(n, m, dtype)
    return _lib().gb_gather_sub_max_clusters(_DTYPE_CODE[dtype], n, m, p.groups, p.cluster, p.warps)


_KERNEL_NAMES = ("gather_sub_kernel", "gather_lane_kernel", "idxadd_kernel", "splat2_kernel",
                 "fma1_kernel", "null_kernel")


def sass_i2f(library) -> dict:
    """``parse_sass`` of ``cuobjdump -sass`` of a built K5 library."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    return parse_sass(subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                                     text=True, check=True).stdout)


def parse_sass(text: str) -> dict:
    """For each kernel in ``cuobjdump -sass`` output: {"i2f": its integer
    to float conversions (``I2F``, and ``I2FP``, sm_90's form for a 32-bit
    integer), "in_loops": those between a backward branch and its target,
    "loops": backward branches}.  Branch targets may be addresses
    (``BRA 0x1a0``) or labels (``BRA `(.L_x_3)``)."""
    out = {}
    for body in re.split(r"\n\s*Function : ", text)[1:]:
        mangled = body.split(None, 1)[0]
        base = next((k for k in _KERNEL_NAMES if k in mangled), mangled)
        name = base + ("<bf16>" if "bfloat16" in mangled else "<float>" if base == "gather_sub_kernel" else "")
        pending, labels, ops, branches = [], {}, [], []
        for line in body.splitlines():
            label = re.match(r"\s*(\.L_x_\d+):", line)
            if label:
                pending.append(label.group(1))  # names the next instruction
                continue
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if not ins:
                continue
            addr = int(ins.group(1), 16)
            labels.update((k, addr) for k in pending)
            pending = []
            ops.append((addr, ins.group(2)))
            target = re.search(r"\bBRA\b.*?(?:`\((\.L_x_\d+)\)|0x([0-9a-f]+))", ins.group(2))
            if target:
                branches.append((addr, target.group(1), target.group(2)))
        loops = []
        for at, lab, hexa in branches:
            dest = labels.get(lab) if lab else int(hexa, 16)
            if dest is not None and dest < at:  # BRA to itself: the trap after EXIT
                loops.append((dest, at))
        i2f = [a for a, t in ops if re.match(r"(@!?U?P\w+\s+)?I2FP?\b", t)]
        out[name] = {"i2f": len(i2f), "in_loops": sum(any(lo <= a <= hi for lo, hi in loops) for a in i2f),
                     "loops": len(loops)}
    return out


def canary_ms() -> float:
    """One 4096^3 bf16 ``torch.matmul`` on the card, ms: a health check of
    its tensor cores, as the JAX script's canary."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(4096, 4096, generator=gen, device="cuda", dtype=torch.bfloat16)
    return cuda_ms(lambda: torch.matmul(a, a), 5)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--sass"]:
        library = argv[1] if len(argv) > 1 else _build.load("gatherbench").path
        print(json.dumps(sass_i2f(library), indent=1))
        return 0
    if not torch.cuda.is_available():
        print("gatherbench: no CUDA device; the microbenchmarks run on the card", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0), "canary_matmul_ms": canary_ms()}
    results = sweep()
    out["us_per_op"] = {k: r["us_per_op"] for k, r in results.items()}
    out["us_per_call"] = {k: r["ms"] * 1e3 for k, r in results.items()}
    out["floor_us"] = {k: r["floor_ms"] * 1e3 for k, r in results.items()}
    out["library_us"] = {k: r["library_us"] for k, r in results.items()}
    out["bound_us_per_op"] = {k: r["bound_ms"] * 1e3 / R for k, r in results.items()}
    out["bound_us"] = {k: r["bound_ms"] * 1e3 for k, r in results.items()}
    out["smem_wavefront_us"] = {k: r["smem_wavefront_ms"] * 1e3 for k, r in results.items()
                                if "smem_wavefront_ms" in r}
    out["wavefronts_per_read"] = {k: r["wavefronts_per_read"] for k, r in results.items()
                                  if "wavefronts_per_read" in r}
    out["lane_conflicts_us"] = {f"{w}-way": {k: v * 1e3 for k, v in r.items()}
                                for w, r in conflict_sweep().items()}
    out["canary_matmul_ms_after"] = canary_ms()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
