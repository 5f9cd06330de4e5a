"""Batched linear assignment: the Hungarian matching of the DINO losses.

``linear_assignment(cost, row_valid)`` solves P independent problems at
once: ``cost`` is (P, R, C) float32 with R <= C, ``row_valid`` (P, R) bool,
and the result (P, R) int64 holds the column assigned to each valid row
(invalid rows get 0), such that no column serves two rows and the valid
rows' total cost is least.  Only the valid rows are solved.  Costs must be
finite.

The algorithm is the one ``optax.assignment.hungarian_algorithm`` runs in
the JAX package (``codetr_tpu/parallel/losses.py:116``): the e-maxx
shortest augmenting path, rows taken in index order, potentials and
distances in float64, ties to the lowest column index (``jnp.argmin``'s
rule).  For CPU tensors it runs ``linear_assignment_plain``, that algorithm
in torch ops vectorised over the columns; for CUDA tensors it launches the
hand-written kernel ``csrc/hungarian.cu`` (one thread block per problem) on
the current stream, with no host round trip, or raises.  The two do the
same float64 operations in the same order, so they agree exactly, ties
included.  ``launches`` counts the kernel's launches (callers reset it to 0
and read it).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from codetr_torch.ops import _build

launches = 0


def _check(cost: torch.Tensor, row_valid: torch.Tensor) -> None:
    if cost.dim() != 3:
        raise ValueError(f"cost must be (P, R, C), got {tuple(cost.shape)}")
    if cost.dtype != torch.float32:
        raise TypeError(f"cost must be float32, got {cost.dtype}")
    P, R, C = cost.shape
    if R > C:
        raise ValueError(f"needs rows <= columns, got R = {R}, C = {C}")
    if row_valid.shape != (P, R) or row_valid.dtype != torch.bool:
        raise ValueError(f"row_valid must be ({P}, {R}) bool, got {tuple(row_valid.shape)} {row_valid.dtype}")
    if row_valid.device != cost.device:
        raise ValueError(f"tensors on {row_valid.device} and {cost.device}")


def _solve_plain(cost: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One (R, C) problem; the kernel's steps one for one (1-based columns,
    column 0 the search's root)."""
    R, C = cost.shape
    dev = cost.device
    inf = float("inf")
    u = torch.zeros(R + 1, dtype=torch.float64, device=dev)
    v = torch.zeros(C + 1, dtype=torch.float64, device=dev)
    p = torch.zeros(C + 1, dtype=torch.int64, device=dev)  # the row (1-based) of each column
    way = torch.zeros(C + 1, dtype=torch.int64, device=dev)
    for i in (valid.nonzero().flatten() + 1).tolist():
        p[0] = i
        j0 = 0
        minv = torch.full((C,), inf, dtype=torch.float64, device=dev)  # columns 1..C
        used = torch.zeros(C + 1, dtype=torch.bool, device=dev)
        while True:
            used[j0] = True
            i0 = int(p[j0])
            free = ~used[1:]
            cur = cost[i0 - 1].double() - u[i0] - v[1:]
            better = free & (cur < minv)
            minv = torch.where(better, cur, minv)
            way[1:] = torch.where(better, j0, way[1:])
            masked = torch.where(free, minv, inf)
            j1 = int(torch.argmin(masked)) + 1  # the first of equal minima
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            minv = torch.where(free, minv - delta, minv)
            j0 = j1
            if int(p[j0]) == 0:
                break
        while j0:
            j1 = int(way[j0])
            p[j0] = p[j1]
            j0 = j1
    cols = torch.zeros(R, dtype=torch.int64, device=dev)
    taken = (p[1:] > 0).nonzero().flatten()
    cols[p[1:][taken] - 1] = taken
    return cols


def linear_assignment_plain(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """The plain version: each problem in turn, any device (it reads the
    search's state on the host every step)."""
    _check(cost, row_valid)
    if cost.shape[0] == 0:
        return torch.zeros(cost.shape[:2], dtype=torch.int64, device=cost.device)
    return torch.stack([_solve_plain(c, v) for c, v in zip(cost, row_valid)])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    lib = _build.load("hungarian").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hungarian_solve.argtypes = [p, p, p, i, i, i, p, p]
    lib.hungarian_solve.restype = i
    lib.hungarian_col_bytes.argtypes = [i]
    lib.hungarian_col_bytes.restype = ctypes.c_longlong
    lib.hungarian_uses_shared.argtypes = [i, i]
    lib.hungarian_uses_shared.restype = i
    return lib


def uses_shared_memory(R: int, C: int) -> bool:
    """Whether the kernel keeps an (R, C) problem's per-column state in
    shared memory (else in a global scratch); loads the library."""
    return bool(_lib().hungarian_uses_shared(R, C))


def _launch(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    global launches
    P, R, C = cost.shape
    cols = torch.empty(P, R, dtype=torch.int64, device=cost.device)
    if P == 0 or R == 0:
        return cols
    lib = _lib()
    cost, row_valid = cost.contiguous(), row_valid.contiguous()
    scratch = None
    if not lib.hungarian_uses_shared(R, C):
        scratch = torch.empty(P * lib.hungarian_col_bytes(C), dtype=torch.uint8, device=cost.device)
    with torch.cuda.device(cost.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hungarian_solve(cost.data_ptr(), row_valid.data_ptr(), cols.data_ptr(), P, R, C,
                                  None if scratch is None else scratch.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hungarian_solve failed: code {err} (negative: bad argument; positive: cudaError_t)")
    launches += 1
    return cols


def linear_assignment(cost: torch.Tensor, row_valid: torch.Tensor) -> torch.Tensor:
    """(P, R, C) float32 costs, (P, R) bool -> (P, R) int64 columns."""
    _check(cost, row_valid)
    if cost.device.type == "cpu":
        return linear_assignment_plain(cost, row_valid)
    if cost.device.type != "cuda":
        raise ValueError(f"linear_assignment runs on CPU (plain version) or CUDA (kernel), not {cost.device}")
    return _launch(cost, row_valid)
