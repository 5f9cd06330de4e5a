"""Multi-scale deformable attention (MSDA): the CUDA kernels' wrappers and
their plain PyTorch versions.

Sampling semantics are ``grid_sample``'s with ``mode='bilinear',
padding_mode='zeros', align_corners=False``: a normalised location ``loc``
maps to pixel ``loc * size - 0.5``; of the four bilinear corners, those
outside the level contribute zero.  Results are exact for any offset.

Three public entry points keep the JAX package's signatures and layouts:

- ``msda_grid_packed(value, spatial_shapes, cpk, num_points, impl="auto")``:
  the encoder's packed coordinates ``cpk`` (bs, K, C) = [x(HLP) | y(HLP) |
  w(HLP) | pad], HLP = heads*levels*points in (h, L, P) order.
- ``msda_grid_qm(value, spatial_shapes, x, y, w, impl="auto")``: grid
  queries on q-minor coordinates, x, y and w each (bs, h, L, P, K);
  ``impl="grid"`` / ``"grid_pallas"`` take the shift-window function of
  ``ops/msda_grid.py`` (kernel ``csrc/msda_shift_fwd.cu``) plus an exact
  correction of the taps outside its window, decided on the device (K3's
  correction entry, ``msda_qm_correction_fwd``).
- ``multi_scale_deformable_attention(value, spatial_shapes,
  sampling_locations, attention_weights, grid_queries=False)``: the
  reference layout, locations (bs, Q, h, L, P, 2) and weights
  (bs, Q, h, L, P) (the decoder); with ``grid_queries=True`` they are moved
  to q-minor for ``msda_grid_qm``.

``msda_packed_level(value, spatial_shapes, cpk, num_points, plan, lq)`` is
K1 on one query level's grid queries (its level entry, with a given plan:
``tools/winbench.py`` times one level a call, as the JAX kernel runs).

``impl="reference"`` (the packed and reference-layout entries, and every
layer of a model built with ``msda_impl="reference"``) is the JAX package's
exact-oracle option: the plain version on any device, no kernel.

``value`` is (bs, K, h, d) in float32 or bfloat16, coordinates and weights
are float32, and the result is (bs, Q, h*d) in the value's dtype, with fp32
accumulation.  All are differentiable in the value, the coordinates and the
weights.  For CPU tensors they run the plain version (``msda_plain``); for
CUDA tensors they launch the hand-written forward kernel
(``csrc/msda_fwd.cu``), whose gradient launches the backward kernel
(``csrc/msda_bwd.cu``), or raise.  ``msda_backward_plain`` is the
backward's plain version.  The packed and reference-layout entries, the
two that ``CoDETR.forward`` reaches, are ``torch.library`` custom ops
(``codetr::msda_packed``, ``codetr::msda_reference``), so that an exported
program keeps them; the q-minor entry keeps a ``torch.autograd.Function``.
``launches`` counts the packed and reference-layout forward launches,
``launches_qm`` the q-minor ones, ``launches_shift`` the shift-window ones,
``launches_correction`` the correction entry's and ``launches_bwd`` every
backward launch (callers reset them to 0 and read them).
"""

from __future__ import annotations

import ctypes
import functools
import sys
from typing import List, Sequence, Tuple

import torch

from codetr_torch.ops import _build, msda_tiles

Shapes = Sequence[Tuple[int, int]]

launches = 0
launches_qm = 0
launches_bwd = 0
launches_shift = 0
launches_correction = 0
# out-of-envelope taps of the last corrected grid-impl msda_grid_qm call: a
# 0-dim int64 tensor on the call's device (reading it on the host syncs)
last_out_of_envelope = None

_MAX_LEVELS = 8
_MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(value: torch.Tensor, spatial_shapes: Shapes, *coords: torch.Tensor) -> None:
    if value.dim() != 4:
        raise ValueError(f"value must be (bs, K, h, d), got {tuple(value.shape)}")
    total = sum(h * w for h, w in spatial_shapes)
    if total != value.shape[1]:
        raise ValueError(f"spatial_shapes cover {total} keys, value has {value.shape[1]}")
    if value.dtype not in _DTYPE_CODE:
        raise TypeError(f"value dtype must be float32 or bfloat16, got {value.dtype}")
    for c in coords:
        if c.dtype != torch.float32:
            raise TypeError(f"coordinates and weights must be float32, got {c.dtype}")
        if c.device != value.device:
            raise ValueError(f"tensors on {c.device} and {value.device}")


def msda_plain(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, Q, h, L, P) normalised x
    y: torch.Tensor,  # (bs, Q, h, L, P) normalised y
    w: torch.Tensor,  # (bs, Q, h, L, P) attention weights
    q_chunk: int = 8192,
) -> torch.Tensor:
    """Exact MSDA as a flat gather of the 4 bilinear corners, chunked over
    queries so the gathered rows stay bounded (at the 768x1152 encoder scale
    an unchunked gather would materialise ~6 GB).  Any device."""
    bs, K, h, d = value.shape
    Q, L, P = x.shape[1], x.shape[3], x.shape[4]
    dev = value.device
    table = value.reshape(bs * K * h, d)
    shape5 = (1, 1, 1, L, 1)
    widths = torch.tensor([ww for _, ww in spatial_shapes], device=dev).view(shape5)
    heights = torch.tensor([hh for hh, _ in spatial_shapes], device=dev).view(shape5)
    starts = [0]
    for hh, ww in spatial_shapes[:-1]:
        starts.append(starts[-1] + hh * ww)
    start = torch.tensor(starts, device=dev).view(shape5)
    size_x, size_y = widths.float(), heights.float()
    b_off = (torch.arange(bs, device=dev) * K).view(bs, 1, 1, 1, 1)
    head = torch.arange(h, device=dev).view(1, 1, h, 1, 1)

    out = torch.empty(bs, Q, h, d, dtype=value.dtype, device=dev)
    for q0 in range(0, Q, q_chunk):
        q1 = min(Q, q0 + q_chunk)
        px = x[:, q0:q1] * size_x - 0.5
        py = y[:, q0:q1] * size_y - 0.5
        wc = w[:, q0:q1]
        fx, fy = torch.floor(px), torch.floor(py)
        tx, ty = px - fx, py - fy
        x0, y0 = fx.long(), fy.long()
        acc = None
        for cdx, cdy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, yi = x0 + cdx, y0 + cdy
            valid = (xi >= 0) & (xi < widths) & (yi >= 0) & (yi < heights)
            k = (
                start
                + yi.clamp(min=0).minimum(heights - 1) * widths
                + xi.clamp(min=0).minimum(widths - 1)
            )
            rows = table[((b_off + k) * h + head).reshape(-1)].view(*k.shape, d).float()
            wx = tx if cdx else 1.0 - tx
            wy = ty if cdy else 1.0 - ty
            cw = wx * wy * valid.float() * wc  # (bs, q, h, L, P)
            term = rows * cw[..., None]
            acc = term if acc is None else acc + term
        out[:, q0:q1] = acc.sum(dim=(3, 4)).to(value.dtype)
    return out.reshape(bs, Q, h * d)


def _unpack(cpk: torch.Tensor, h: int, L: int, P: int):
    bs, K, _ = cpk.shape
    HLP = h * L * P
    return tuple(cpk[..., i * HLP:(i + 1) * HLP].reshape(bs, K, h, L, P) for i in range(3))


def unpack_coords_qmajor(cpk: torch.Tensor, num_heads: int, num_levels: int, num_points: int):
    """(bs, K, C) packed q-major coordinates -> q-minor (x, y, w), each a
    (bs, h, L, P, K) view."""
    return tuple(a.permute(0, 2, 3, 4, 1) for a in _unpack(cpk, num_heads, num_levels, num_points))


def pack_coords_qmajor(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """q-minor (bs, h, L, P, K) coordinates -> packed q-major (bs, K, 3*HLP)
    fp32 (no pad columns)."""
    bs, K = x.shape[0], x.shape[-1]
    return torch.cat([a.reshape(bs, -1, K) for a in (x, y, w)], 1).transpose(1, 2).float().contiguous()


def msda_grid_packed_plain(value, spatial_shapes, cpk, num_points):
    """Plain PyTorch version of ``msda_grid_packed`` on any device."""
    h = value.shape[2]
    return msda_plain(value, spatial_shapes, *_unpack(cpk, h, len(spatial_shapes), num_points))


def msda_reference_qm(value, spatial_shapes, x, y, w):
    """Plain PyTorch version of ``msda_grid_qm`` on any device: x, y and w
    (bs, h, L, P, Q) fp32 -> (bs, Q, h*d)."""
    return msda_plain(value, spatial_shapes, *(a.permute(0, 4, 1, 2, 3) for a in (x, y, w)))


def multi_scale_deformable_attention_plain(
    value, spatial_shapes, sampling_locations, attention_weights
):
    """Plain PyTorch version of ``multi_scale_deformable_attention``."""
    loc = sampling_locations
    return msda_plain(value, spatial_shapes, loc[..., 0], loc[..., 1], attention_weights)


def msda_backward_plain(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, Q, h, L, P)
    y: torch.Tensor,
    w: torch.Tensor,
    grad_out: torch.Tensor,  # (bs, Q, h*d)
):
    """Plain version of the MSDA backward: the vector-Jacobian product of
    ``msda_plain`` taken by autograd -> (grad_value, grad_x, grad_y,
    grad_w), each shaped like its input.  Any device."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (value, x, y, w)]
        out = msda_plain(leaves[0], spatial_shapes, *leaves[1:])
        return torch.autograd.grad(out, leaves, grad_out.to(out.dtype))


# the tile plan's arrays, then halo and smem_bytes
_PLAN_ARRAYS = ("tile_h", "tile_w", "win_h", "win_w", "staged", "off_b", "off_acc")
_PLAN_ARGTYPES = (*[ctypes.POINTER(ctypes.c_int)] * len(_PLAN_ARRAYS), ctypes.c_int, ctypes.c_int)


@functools.lru_cache(maxsize=64)
def plan_ints(plan: msda_tiles.TilePlan) -> Tuple[int, ...]:
    """``plan`` as one flat int sequence: ``_PLAN_ARRAYS`` concatenated, then
    halo and smem_bytes (``codetr::msda_packed``'s ``plan`` argument, which
    ``csrc/msda_ops.cpp`` splits the same way)."""
    arrays = plan.c_arrays()
    return (*[int(v) for k in _PLAN_ARRAYS for v in arrays[k]], int(plan.halo), int(plan.smem_bytes))


@functools.lru_cache(maxsize=64)
def _plan_args_of(flat: Tuple[int, ...], num_levels: int):
    """The C entries' plan arguments from ``plan_ints``' sequence: one
    entry per query level, or per (lq, lt) pair, of each array."""
    L = num_levels
    lengths = (L, L, L * L, L * L, L * L, L, L)
    if len(flat) != sum(lengths) + 2:
        raise ValueError(f"a plan for {num_levels} levels has {sum(lengths) + 2} ints, got {len(flat)}")
    arrays, at = [], 0
    for n in lengths:
        arrays.append((ctypes.c_int * n)(*flat[at:at + n]))
        at += n
    return (*arrays, flat[-2], flat[-1])


def _plan_args(plan: msda_tiles.TilePlan):
    """The C entries' plan arguments for ``plan``."""
    return _plan_args_of(plan_ints(plan), len(plan.shapes))


def packed_plan(spatial_shapes: Shapes, value_dtype: torch.dtype, head_dim: int, num_points: int) -> List[int]:
    """K1's forward tile plan (``msda_tiles.encoder_tile_plan``) for static
    shapes, as ``codetr::msda_packed`` takes it."""
    plan = msda_tiles.encoder_tile_plan(spatial_shapes, value_dtype, head_dim=head_dim, points=num_points)
    return list(plan_ints(plan))


@functools.cache
def _fwd_lib() -> ctypes.CDLL:
    """The built forward kernel library, with its C signatures declared."""
    lib = _build.load("msda_fwd").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.msda_packed_fwd_levels.argtypes = [p, p, p, i, i, i, i, i, i, i, i, ip, ip, *_PLAN_ARGTYPES, i, i, p]
    lib.msda_packed_fwd_levels.restype = i
    lib.msda_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, ip, ip, p]
    lib.msda_fwd.restype = i
    lib.msda_qm_fwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, ip, ip, *_PLAN_ARGTYPES, p]
    lib.msda_qm_fwd.restype = i
    lib.msda_qm_correction_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ip, ip,
                                           *_PLAN_ARGTYPES, p]
    lib.msda_qm_correction_fwd.restype = i
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The built backward kernel library, with its C signatures declared."""
    lib = _build.load("msda_bwd").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.msda_packed_bwd.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, ip, ip, *_PLAN_ARGTYPES, p]
    lib.msda_packed_bwd.restype = i
    lib.msda_bwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ip, ip, p]
    lib.msda_bwd.restype = i
    lib.msda_qm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, ip, ip, p]
    lib.msda_qm_bwd.restype = i
    return lib


def _kernel_checks(value: torch.Tensor, spatial_shapes: Shapes, *coords: torch.Tensor) -> None:
    if len(spatial_shapes) > _MAX_LEVELS:
        raise ValueError(f"the kernel takes at most {_MAX_LEVELS} levels")
    if value.shape[3] > _MAX_HEAD_DIM:
        raise ValueError(f"the kernel takes head dims up to {_MAX_HEAD_DIM}")
    for t in (value, *coords):
        if not t.is_contiguous():
            raise ValueError("the kernel takes contiguous tensors")


def _level_arrays(spatial_shapes: Shapes):
    L = len(spatial_shapes)
    hs = (ctypes.c_int * L)(*[int(hh) for hh, _ in spatial_shapes])
    ws = (ctypes.c_int * L)(*[int(ww) for _, ww in spatial_shapes])
    return hs, ws


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed: code {err} (negative: bad argument; positive: cudaError_t)")


def _launch_packed(value, spatial_shapes, cpk, num_points, plan: Sequence[int], levels=None):
    """K1 on the packed coordinates with ``plan``, ``packed_plan``'s ints,
    through its level entry ``msda_packed_fwd_levels`` on the query levels
    ``levels`` = (begin, end), all of them by default (the launch
    ``csrc/msda_ops.cpp`` makes).  Rows outside the range stay as allocated."""
    global launches
    _kernel_checks(value, spatial_shapes, cpk)
    bs, K, h, d = value.shape
    L = len(spatial_shapes)
    lq_begin, lq_end = levels if levels is not None else (0, L)
    lib = _fwd_lib()
    plan_args = _plan_args_of(tuple(int(v) for v in plan), L)
    out = torch.empty(bs, K, h * d, dtype=value.dtype, device=value.device)
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_packed_fwd_levels(
            value.data_ptr(), cpk.data_ptr(), out.data_ptr(), _DTYPE_CODE[value.dtype],
            bs, K, h, d, L, num_points, cpk.shape[2], hs, ws,
            *plan_args, lq_begin, lq_end, stream,
        )
    _raise_on(err, "msda_packed_fwd_levels")
    launches += 1
    return out


def _level_rows(spatial_shapes: Shapes, lq: int) -> slice:
    """The keys (query rows) of level ``lq``."""
    sizes = [int(hh) * int(ww) for hh, ww in spatial_shapes]
    if not 0 <= lq < len(sizes):
        raise ValueError(f"query level {lq} of {len(sizes)} levels")
    start = sum(sizes[:lq])
    return slice(start, start + sizes[lq])


def msda_packed_level(value, spatial_shapes, cpk, num_points, plan: msda_tiles.TilePlan, lq: int):
    """K1 on the grid queries of one query level ``lq`` -> (bs, K_lq, h*d),
    the rows of that level of ``msda_grid_packed``'s output.  On the card
    it launches K1's level entry with ``plan`` (``msda_tiles.
    encoder_tile_plan``, tiles overridable): one block per tile of that
    level, writing only its rows of an output of all K rows, whose view it
    returns.  On the CPU: the plain version on that level's queries.
    Counts in ``launches``."""
    _check(value, spatial_shapes, cpk)
    rows = _level_rows(spatial_shapes, lq)
    if _route(value) == "cpu":
        x, y, w = (a[:, rows] for a in _unpack(cpk, value.shape[2], len(spatial_shapes), num_points))
        return msda_plain(value, spatial_shapes, x, y, w)
    if plan.backward or plan.shapes != tuple((int(a), int(b)) for a, b in spatial_shapes) \
            or plan.head_dim != value.shape[3] or plan.points != num_points \
            or plan.element_size != value.element_size():
        raise ValueError("the plan was made for other shapes, a backward, another head dim, points or dtype")
    return _launch_packed(value, spatial_shapes, cpk, num_points, plan_ints(plan), levels=(lq, lq + 1))[:, rows]


def _launch_reference(value, spatial_shapes, loc, attn):
    global launches
    _kernel_checks(value, spatial_shapes, loc, attn)
    bs, K, h, d = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    lib = _fwd_lib()
    out = torch.empty(bs, Q, h * d, dtype=value.dtype, device=value.device)
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_fwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[value.dtype], bs, K, Q, h, d, L, P, hs, ws, stream,
        )
    _raise_on(err, "msda_fwd")
    launches += 1
    return out


def _grad_rows(value, grad_out, num_queries):
    """The upstream gradient as the backward kernel reads it: contiguous
    (bs, Q, h*d) in the value's dtype (the forward's output dtype)."""
    bs, _, h, d = value.shape
    if grad_out.shape != (bs, num_queries, h * d):
        raise ValueError(f"grad_out must be ({bs}, {num_queries}, {h * d}), got {tuple(grad_out.shape)}")
    return grad_out.to(value.dtype).contiguous()


def _launch_packed_bwd(value, spatial_shapes, cpk, num_points, grad_out):
    """-> (grad_value in the value's dtype, grad_cpk (bs, K, C) fp32, its
    pad columns zero)."""
    global launches_bwd
    bs, K, h, d = value.shape
    g = _grad_rows(value, grad_out, K)
    _kernel_checks(value, spatial_shapes, cpk, g)
    L, C = len(spatial_shapes), cpk.shape[2]
    lib = _bwd_lib()
    plan = msda_tiles.encoder_tile_plan(spatial_shapes, value.dtype, head_dim=d, points=num_points,
                                        backward=True)
    # fp32 accumulator for the kernel's atomics, zeroed
    grad_value = torch.zeros(bs, K, h, d, dtype=torch.float32, device=value.device)
    grad_cpk = torch.zeros(bs, K, C, dtype=torch.float32, device=value.device)
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_packed_bwd(
            value.data_ptr(), cpk.data_ptr(), g.data_ptr(), grad_value.data_ptr(),
            grad_cpk.data_ptr(), _DTYPE_CODE[value.dtype], bs, K, h, d, L, num_points, C,
            hs, ws, *_plan_args(plan), stream,
        )
    _raise_on(err, "msda_packed_bwd")
    launches_bwd += 1
    return grad_value.to(value.dtype), grad_cpk


def _launch_reference_bwd(value, spatial_shapes, loc, attn, grad_out):
    """-> (grad_value in the value's dtype, grad_loc, grad_attn), fp32
    gradients in the coordinates' layouts."""
    global launches_bwd
    bs, K, h, d = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    g = _grad_rows(value, grad_out, Q)
    _kernel_checks(value, spatial_shapes, loc, attn, g)
    lib = _bwd_lib()
    grad_value = torch.zeros(bs, K, h, d, dtype=torch.float32, device=value.device)
    grad_loc, grad_attn = torch.empty_like(loc), torch.empty_like(attn)
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_bwd(
            value.data_ptr(), loc.data_ptr(), attn.data_ptr(), g.data_ptr(),
            grad_value.data_ptr(), grad_loc.data_ptr(), grad_attn.data_ptr(),
            _DTYPE_CODE[value.dtype], bs, K, Q, h, d, L, P, hs, ws, stream,
        )
    _raise_on(err, "msda_bwd")
    launches_bwd += 1
    return grad_value.to(value.dtype), grad_loc, grad_attn


def _launch_qm(value, spatial_shapes, x, y, w):
    """K3 on the encoder tiles (K1's plan): x, y, w q-minor (bs, h, L, P,
    K), the queries the key grid."""
    global launches_qm
    _kernel_checks(value, spatial_shapes, x, y, w)
    bs, K, h, d = value.shape
    L, P = x.shape[2], x.shape[3]
    lib = _fwd_lib()
    plan = msda_tiles.encoder_tile_plan(spatial_shapes, value.dtype, head_dim=d, points=P)
    out = torch.empty(bs, K, h * d, dtype=value.dtype, device=value.device)
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_qm_fwd(
            value.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[value.dtype], bs, K, h, d, L, P, hs, ws, *_plan_args(plan), stream,
        )
    _raise_on(err, "msda_qm_fwd")
    launches_qm += 1
    return out


def _launch_correction(value, spatial_shapes, x, y, w, count, out):
    """K3's correction entry: adds the exact MSDA of the taps whose weight
    in ``w`` is not 0 into ``out`` (bs, K, h*d), the window call's result,
    in place, and returns it.  ``count`` is the number of those taps, a
    0-dim int64 tensor on the card; the kernel's blocks return at once when
    it is 0.  Reads nothing on the host."""
    global launches_correction
    _kernel_checks(value, spatial_shapes, x, y, w, out)
    bs, K, h, d = value.shape
    L, P = x.shape[2], x.shape[3]
    if out.shape != (bs, K, h * d) or out.dtype != value.dtype:
        raise ValueError(f"out must be ({bs}, {K}, {h * d}) {value.dtype}, got {tuple(out.shape)} {out.dtype}")
    if count.dtype != torch.int64 or count.numel() != 1 or count.device != value.device:
        raise ValueError(f"count must be one int64 on {value.device}, got {count.dtype} {tuple(count.shape)} "
                         f"on {count.device}")
    lib = _fwd_lib()
    plan = msda_tiles.correction_plan(spatial_shapes, value.dtype, head_dim=d, points=P)
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_qm_correction_fwd(
            value.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(), count.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[value.dtype], bs, K, h, d, L, P, hs, ws, *_plan_args(plan), stream,
        )
    _raise_on(err, "msda_qm_correction_fwd")
    launches_correction += 1
    return out


def _launch_qm_bwd(value, spatial_shapes, x, y, w, grad_out):
    """-> (grad_value in the value's dtype, grad_x, grad_y, grad_w), fp32
    coordinate gradients in the q-minor layout."""
    global launches_bwd
    bs, K, h, d = value.shape
    L, P, Q = x.shape[2], x.shape[3], x.shape[4]
    g = _grad_rows(value, grad_out, Q)
    _kernel_checks(value, spatial_shapes, x, y, w, g)
    lib = _bwd_lib()
    grad_value = torch.zeros(bs, K, h, d, dtype=torch.float32, device=value.device)
    grads = [torch.empty_like(a) for a in (x, y, w)]
    hs, ws = _level_arrays(spatial_shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_qm_bwd(
            value.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(), g.data_ptr(),
            grad_value.data_ptr(), *(a.data_ptr() for a in grads),
            _DTYPE_CODE[value.dtype], bs, K, Q, h, d, L, P, hs, ws, stream,
        )
    _raise_on(err, "msda_qm_bwd")
    launches_bwd += 1
    return (grad_value.to(value.dtype), *grads)


def _flat_shapes(spatial_shapes: Shapes) -> list:
    """Level shapes as the custom ops take them: [h0, w0, h1, w1, ...]."""
    return [int(v) for hw in spatial_shapes for v in hw]


def _pairs(flat: Sequence[int]) -> tuple:
    return tuple((int(flat[i]), int(flat[i + 1])) for i in range(0, len(flat), 2))


# The forward entries that CoDETR.forward reaches as ``torch.library``
# custom ops, so that ``torch.export`` records them as ``codetr::`` nodes
# (an exported program then runs the kernel wherever it is loaded, never a
# traced copy of the plain version).  Each has a fake implementation (the
# output's shape and dtype; it touches no ctypes), a CPU one (the plain
# version) and a CUDA one (the kernel), and its gradient is registered with
# ``register_autograd``: the backward kernel on the card, the plain backward
# on the CPU.  ``codetr::msda_packed`` carries K1's tile plan as an argument
# (``msda_grid_packed`` builds it from the static shapes), so an exported
# graph holds it as a constant and a process with no Python can launch the
# kernel: ``csrc/msda_ops.cpp`` registers the same two schemas from C++ for
# such a process (an AOTInductor package's, ``tools/aoti_run.py``).  The
# two registrations never meet in one process: a second definition of a
# schema raises.
PACKED_SCHEMA = "(Tensor value, Tensor cpk, int[] spatial_shapes, int num_points, int[] plan) -> Tensor"
REFERENCE_SCHEMA = "(Tensor value, Tensor loc, Tensor attn, int[] spatial_shapes) -> Tensor"


@torch.library.custom_op("codetr::msda_packed", mutates_args=(), device_types="cpu", schema=PACKED_SCHEMA)
def _packed_op(value, cpk, spatial_shapes, num_points, plan):
    return msda_grid_packed_plain(value, _pairs(spatial_shapes), cpk, num_points)


@_packed_op.register_kernel("cuda")
def _(value, cpk, spatial_shapes, num_points, plan):
    return _launch_packed(value, _pairs(spatial_shapes), cpk, num_points, plan)


@_packed_op.register_fake
def _(value, cpk, spatial_shapes, num_points, plan):
    bs, K, h, d = value.shape
    return value.new_empty(bs, K, h * d)


def _packed_setup(ctx, inputs, output):
    value, cpk, spatial_shapes, num_points, _ = inputs
    ctx.save_for_backward(value, cpk)
    ctx.spatial_shapes, ctx.num_points = _pairs(spatial_shapes), num_points


def _packed_backward(ctx, grad_out):
    value, cpk = ctx.saved_tensors
    shapes, P = ctx.spatial_shapes, ctx.num_points
    if _route(value) == "cuda":
        grad_value, grad_cpk = _launch_packed_bwd(value, shapes, cpk, P, grad_out)
    else:
        h = value.shape[2]
        grads = msda_backward_plain(value, shapes, *_unpack(cpk, h, len(shapes), P), grad_out)
        grad_value = grads[0]
        grad_cpk = torch.zeros_like(cpk)
        HLP = grads[1][0, 0].numel()
        for i, g in enumerate(grads[1:]):
            grad_cpk[..., i * HLP:(i + 1) * HLP] = g.reshape(*cpk.shape[:2], HLP)
    return grad_value, grad_cpk, None, None, None


_packed_op.register_autograd(_packed_backward, setup_context=_packed_setup)


@torch.library.custom_op("codetr::msda_reference", mutates_args=(), device_types="cpu",
                         schema=REFERENCE_SCHEMA)
def _reference_op(value, loc, attn, spatial_shapes):
    return multi_scale_deformable_attention_plain(value, _pairs(spatial_shapes), loc, attn)


@_reference_op.register_kernel("cuda")
def _(value, loc, attn, spatial_shapes):
    return _launch_reference(value, _pairs(spatial_shapes), loc, attn)


@_reference_op.register_fake
def _(value, loc, attn, spatial_shapes):
    bs, _, h, d = value.shape
    return value.new_empty(bs, loc.shape[1], h * d)


def _reference_setup(ctx, inputs, output):
    value, loc, attn, spatial_shapes = inputs
    ctx.save_for_backward(value, loc, attn)
    ctx.spatial_shapes = _pairs(spatial_shapes)


def _reference_backward(ctx, grad_out):
    value, loc, attn = ctx.saved_tensors
    shapes = ctx.spatial_shapes
    if _route(value) == "cuda":
        return (*_launch_reference_bwd(value, shapes, loc, attn, grad_out), None)
    gv, gx, gy, gw = msda_backward_plain(value, shapes, loc[..., 0], loc[..., 1], attn, grad_out)
    return gv, torch.stack([gx, gy], -1), gw, None


_reference_op.register_autograd(_reference_backward, setup_context=_reference_setup)


class _QmMSDA(torch.autograd.Function):
    """The q-minor kernel (K3's counterpart) with the backward kernel on
    q-minor strides as its gradient."""

    @staticmethod
    def forward(ctx, value, x, y, w, spatial_shapes):
        ctx.save_for_backward(value, x, y, w)
        ctx.spatial_shapes = spatial_shapes
        return _launch_qm(value, spatial_shapes, x, y, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        value, x, y, w = ctx.saved_tensors
        return (*_launch_qm_bwd(value, ctx.spatial_shapes, x, y, w, grad_out), None)


def _is_dtensor(*ts) -> bool:
    """Whether one of ``ts`` is a DTensor, without importing
    ``torch.distributed.tensor`` (~1 s), which a DTensor's maker did."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor) for t in ts)


def _on_local_tensors(fn, value, *tensors):
    """``fn(value, *tensors)`` (an MSDA entry with its other arguments
    bound) on DTensors, through ``local_map``: each tensor redistributed to
    ``value``'s placements with everything but a batch split
    (``Shard(0)``) replicated, ``fn`` run on the local tensors, and its
    output wrapped with the same placements (MSDA is independent per
    image).

    ``local_map``, not a ``register_sharding`` rule on ``codetr::msda_packed``
    / ``codetr::msda_reference``: a rule would hand the ops' registered
    backward DTensors, and the backward launches its kernel on raw
    pointers; ``local_map`` converts at the boundary with differentiable
    ``to_local`` / ``from_local``, so the ops and their backward (K1, K2, the
    decoder's entries) see ordinary tensors, as on one device.  The
    kernels are unchanged."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    place = tuple(p if p == Shard(0) else Replicate() for p in value.placements)
    return local_map(fn, out_placements=(place,), in_placements=(place,) * (1 + len(tensors)),
                     redistribute_inputs=True)(value, *tensors)


def _route(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise ValueError(f"MSDA runs on CPU (plain version) or CUDA (kernel), not {t.device}")


def msda_grid_packed(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    cpk: torch.Tensor,  # (bs, K, C) fp32 [x(HLP) | y(HLP) | w(HLP) | pad]
    num_points: int,
    *,
    impl: str = "auto",
) -> torch.Tensor:
    """Grid-query (encoder) MSDA on packed coordinates -> (bs, K, h*d).
    ``impl="auto"``: the packed kernel (K1's counterpart) on the card, the
    plain version on the CPU; ``"reference"`` runs the plain version
    ``msda_grid_packed_plain`` on any device.  DTensor arguments run on
    their local tensors (``_on_local_tensors``)."""
    if _is_dtensor(value, cpk):
        return _on_local_tensors(lambda v, c: msda_grid_packed(v, spatial_shapes, c, num_points, impl=impl),
                                 value, cpk)
    _check(value, spatial_shapes, cpk)
    bs, K, h, _ = value.shape
    HLP = h * len(spatial_shapes) * num_points
    if cpk.dim() != 3 or cpk.shape[:2] != (bs, K) or cpk.shape[2] < 3 * HLP:
        raise ValueError(f"cpk must be ({bs}, {K}, >={3 * HLP}), got {tuple(cpk.shape)}")
    _route(value)
    if impl == "reference":
        return msda_grid_packed_plain(value, spatial_shapes, cpk, num_points)
    if impl != "auto":
        raise ValueError(f"unknown packed MSDA impl {impl!r}")
    plan = packed_plan(spatial_shapes, value.dtype, value.shape[3], num_points)
    return _packed_op(value, cpk, _flat_shapes(spatial_shapes), num_points, plan)


def _check_qm(value, spatial_shapes, x, y, w) -> None:
    _check(value, spatial_shapes, x, y, w)
    bs, K, h, _ = value.shape
    want = (bs, h, len(spatial_shapes))
    if x.dim() != 5 or x.shape[:3] != want or x.shape[4] != K or not x.shape == y.shape == w.shape:
        raise ValueError(
            f"x, y, w must be ({bs}, {h}, {len(spatial_shapes)}, P, {K}), got "
            f"{tuple(x.shape)}, {tuple(y.shape)}, {tuple(w.shape)}"
        )


# the shift-window impls and their coarse-pair escape (ops/msda_grid.py)
GRID_MAX_WINDOW = {"grid": None, "grid_pallas": 31}
# every MSDA layer's impl (the JAX package's msda_impl)
MSDA_IMPLS = ("auto", "reference", *GRID_MAX_WINDOW)


def msda_grid_qm(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, h, L, P, K) fp32 normalised x
    y: torch.Tensor,  # (bs, h, L, P, K)
    w: torch.Tensor,  # (bs, h, L, P, K) attention weights
    *,
    impl: str = "auto",
    radius: int = 4,
    envelope: str = "correct",
) -> torch.Tensor:
    """Grid-query MSDA on q-minor coordinates -> (bs, K, h*d).

    ``impl="auto"``: the exact q-minor kernel (K3's counterpart), exact for
    any offset; its plain version is ``msda_reference_qm``.

    ``impl="grid"`` / ``"grid_pallas"``: the shift-window function of
    ``ops/msda_grid.py`` (K4's counterpart; ``"grid"`` without the
    coarse-pair escape, ``"grid_pallas"`` with it at ``max_window=31``),
    exact for taps inside its window envelope of ``radius`` px.  With
    ``envelope="correct"`` the taps outside it are masked out of the window
    call and their exact contribution is added back, so the result is exact
    for any offset.  Nothing is read on the host, so the call can be
    captured: the count of those taps stays on the device
    (``last_out_of_envelope``), and on the card the correction entry of K3
    (``_launch_correction``) is launched every time, adds into the window
    call's output in place, and returns at once when the count is 0 (the
    JAX package's ``lax.cond``); on the CPU the plain correction is added
    unconditionally (in-envelope weights are 0 in it).  The gradient is the
    exact MSDA's, one launch of the backward kernel on q-minor strides.
    ``envelope="unchecked"`` returns the truncated window function.

    ``impl="win"`` is the JAX package's windowed TPU kernel, whose envelope
    is its own: n/a here.  With ``envelope="correct"`` its result is the
    exact function, so it maps to ``"auto"``; ``"unchecked"`` raises.  The
    JAX ``correction_budget`` sizes that kernel's sparse tier and does not
    exist here."""
    global last_out_of_envelope
    _check_qm(value, spatial_shapes, x, y, w)
    if envelope not in ("correct", "unchecked"):
        raise ValueError(f"envelope must be 'correct' or 'unchecked', got {envelope!r}")
    if impl == "win":
        if envelope == "unchecked":
            raise ValueError("impl='win' is the TPU windowed kernel's envelope, n/a in the port; "
                             "its corrected form is impl='auto'")
        impl = "auto"
    if impl == "auto":
        if _route(value) == "cpu":
            return msda_reference_qm(value, spatial_shapes, x, y, w)
        return _QmMSDA.apply(value, x, y, w, spatial_shapes)
    if impl not in GRID_MAX_WINDOW:
        raise ValueError(f"unknown grid impl {impl!r}")
    from codetr_torch.ops import msda_grid  # it builds on this module

    max_window = GRID_MAX_WINDOW[impl]
    if envelope == "unchecked":
        return msda_grid.msda_grid_shift_qm(value, spatial_shapes, x, y, w,
                                            radius=radius, max_window=max_window)
    mask = msda_grid.envelope_mask(spatial_shapes, x, y, radius=radius, max_window=max_window)
    last_out_of_envelope = (~mask).sum()
    if _route(value) == "cpu":
        out = msda_grid.msda_grid_shift_qm(value, spatial_shapes, x, y, torch.where(mask, w, 0.0),
                                           radius=radius, max_window=max_window)
        return out + msda_reference_qm(value, spatial_shapes, x, y, torch.where(mask, 0.0, w))
    return msda_grid.CorrectedShiftMSDA.apply(value, x, y, w, mask, last_out_of_envelope,
                                              msda_grid._key(spatial_shapes), int(radius), max_window)


def multi_scale_deformable_attention(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,  # (bs, Q, h, L, P, 2) fp32
    attention_weights: torch.Tensor,  # (bs, Q, h, L, P) fp32
    grid_queries: bool = False,
    *,
    impl: str = "auto",
    grid_radius: int = 4,
    envelope: str = "correct",
) -> torch.Tensor:
    """Reference-layout MSDA -> (bs, Q, h*d).  With ``grid_queries`` (Q = K,
    the level-concatenated pixel grid) the coordinates move to q-minor for
    ``msda_grid_qm(impl=impl, radius=grid_radius, envelope=envelope)``; the
    grid impls need grid queries and raise without them.
    ``impl="reference"`` runs the plain version
    ``multi_scale_deformable_attention_plain`` on any device, with or
    without grid queries (the JAX package's exact flat gather).  DTensor
    arguments run on their local tensors (``_on_local_tensors``)."""
    if _is_dtensor(value, sampling_locations, attention_weights):
        return _on_local_tensors(
            lambda v, loc, attn: multi_scale_deformable_attention(
                v, spatial_shapes, loc, attn, grid_queries, impl=impl, grid_radius=grid_radius, envelope=envelope),
            value, sampling_locations, attention_weights)
    if impl not in ("auto", "reference") and not grid_queries:
        raise ValueError(f"impl={impl!r} requires grid queries")
    _check(value, spatial_shapes, sampling_locations, attention_weights)
    bs, _, h, _ = value.shape
    L = len(spatial_shapes)
    loc, attn = sampling_locations, attention_weights
    if (
        loc.dim() != 6 or loc.shape[0] != bs or loc.shape[2:4] != (h, L) or loc.shape[5] != 2
        or attn.shape != loc.shape[:5]
    ):
        raise ValueError(
            f"sampling_locations {tuple(loc.shape)} / attention_weights "
            f"{tuple(attn.shape)} do not match value {tuple(value.shape)} and {L} levels"
        )
    if impl == "reference":
        _route(value)
        return multi_scale_deformable_attention_plain(value, spatial_shapes, loc, attn)
    if grid_queries:
        qm = loc.permute(0, 2, 3, 4, 5, 1)  # (bs, h, L, P, 2, Q)
        return msda_grid_qm(value, spatial_shapes, qm[..., 0, :].contiguous(),
                            qm[..., 1, :].contiguous(), attn.permute(0, 2, 3, 4, 1).contiguous(),
                            impl=impl, radius=grid_radius, envelope=envelope)
    _route(value)
    return _reference_op(value, loc, attn, _flat_shapes(spatial_shapes))
