"""Grid-query MSDA in the shift-window formulation: kernel K4's counterpart.

The port of two JAX modules that compute one function:
``codetr_tpu/ops/msda_grid.py`` (the XLA window sweep, ``impl="grid"``)
and ``codetr_tpu/ops/msda_pallas.py`` (its Pallas kernel, ``impl="grid_pallas"``,
which adds the coarse-pair escape).  The encoder's queries are the
level-concatenated pixel grid, so every tap of query ``i`` on target level
``lt`` lies near a static anchor: query ``i`` sees a window of ``W = 2R + 3``
cells per axis, and window cell ``c`` is target row (or column)
``anchor(i) + c - (R + 1)``.  A tap's window coordinate is
``t = pos - anchor + (R + 1)`` with ``pos = loc * size - 0.5`` (the product
rounded first); its two bilinear corners per axis are the cells
``floor(t)`` and ``floor(t) + 1`` with hats ``1 - frac`` and ``frac``.  A
corner contributes only if its cell lies in ``[0, W - 1]`` and its target
row and column inside the level: that is the truncated function the TPU
kernel computes, in which a tap half outside the window keeps its inside
corners.  The dispatcher (``ops/msda.py:msda_grid_qm``) routes the taps
outside ``envelope_mask`` to the exact path, which makes the sum exact.

Per (query level ``lq``, target level ``lt``) pair the anchor is
``floor((i + 0.5) * 2^k - 0.5)`` for the power-of-2 scale ``k`` between the
two axes, and ``R = radius + pair_margin(lq, lt)``.  The coarse-pair
escape: where ``2R + 3 > max_window`` the pair takes the true rational
anchors ``floor((i + 0.5) * Ht / Hq - 0.5)`` and ``R = radius + 2``.
``max_window=None`` means no escape (the JAX ``impl="grid"``), 31 is the
Pallas kernel's default (``impl="grid_pallas"``).

On the card the kernel runs on the encoder kernels' shared-memory query
tiles (``ops/msda_tiles.py``) with windows of its own
(``shift_tile_plan``): the anchors are monotone in the query row and
column, so the cells of a tile's queries on target level ``lt`` lie in
rows ``anchor_y(first row) - (R + 1)`` .. ``anchor_y(last row) + R + 1``
(likewise for columns), clipped to the level.  Each pair's window is the
largest such span over its tiles; a pair whose window fits the budget is
staged in shared memory and serves every corner the truncated function
reads, any other pair reads global memory under the same truncation.

``msda_grid_shift_qm`` takes q-minor (bs, h, L, P, K) fp32 coordinates and
returns (bs, K, h*d) in the value's dtype; ``msda_grid_shift`` is its
reference-layout wrapper (the JAX one, ``max_window=None``), and
``CorrectedShiftMSDA`` the exact function as the corrected dispatch
computes it on the card (K4, then K3's correction entry into K4's output).
For CPU tensors ``msda_grid_shift_qm`` runs the
plain version ``msda_shift_plain`` (its gradient is autograd's, the
truncated function's, as the JAX ``impl="grid"``'s); for CUDA tensors it
launches ``csrc/msda_shift_fwd.cu`` inside a ``torch.autograd.Function``
whose backward is the exact MSDA backward kernel on q-minor strides (the
JAX Pallas entry's gradient is likewise the untruncated oracle's VJP), or
raises.  ``ops.msda.launches_shift`` counts the forward launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from codetr_torch.ops import _build, msda_tiles
from codetr_torch.ops import msda as _msda

Shapes = Sequence[Tuple[int, int]]

PALLAS_MAX_WINDOW = _msda.GRID_MAX_WINDOW["grid_pallas"]  # the JAX Pallas kernel's default


def _ideal_scale(nq: int, nt: int) -> int:
    """Signed power-of-2 scale between pyramid axes: +k if the target is
    ~2^k finer, -k if ~2^k coarser."""
    return round(math.log2(nt / nq)) if nt != nq else 0


def _anchor(i: np.ndarray, nq: int, nt: int) -> np.ndarray:
    """Idealised anchor floor((i + 0.5) * 2^k - 0.5) of query index ``i``."""
    return np.floor((i + 0.5) * 2.0 ** _ideal_scale(nq, nt) - 0.5).astype(np.int64)


def pair_margin(lq: int, lt: int) -> int:
    """Window slack beyond ``radius``: 0 same-level, 2 cross-level (the
    idealised anchor's snap plus the valid-ratio drift between levels)."""
    return 0 if lq == lt else 2


@dataclass(frozen=True)
class PairPlan:
    """One (query level, target level) pair: its window half-width ``R``,
    whether it took the coarse-pair escape, and the integer anchors of the
    query rows and columns on the target level."""

    R: int
    coarse: bool
    anchor_y: np.ndarray  # (Hq,) int64
    anchor_x: np.ndarray  # (Wq,) int64

    @property
    def W(self) -> int:
        return 2 * self.R + 3


def _key(spatial_shapes: Shapes) -> Tuple[Tuple[int, int], ...]:
    return tuple((int(h), int(w)) for h, w in spatial_shapes)


@functools.lru_cache(maxsize=64)
def _pair_plans(shapes: Tuple[Tuple[int, int], ...], radius: int,
                max_window: Optional[int]) -> Tuple[Tuple[PairPlan, ...], ...]:
    plans = []
    for lq, (Hq, Wq) in enumerate(shapes):
        row = []
        iy, ix = np.arange(Hq), np.arange(Wq)
        for lt, (Ht, Wt) in enumerate(shapes):
            R = radius + pair_margin(lq, lt)
            if max_window is not None and 2 * R + 3 > max_window:
                R = radius + 2
                ay = np.floor((iy + 0.5) * (Ht / Hq) - 0.5).astype(np.int64)
                ax = np.floor((ix + 0.5) * (Wt / Wq) - 0.5).astype(np.int64)
                row.append(PairPlan(R, True, ay, ax))
            else:
                row.append(PairPlan(R, False, _anchor(iy, Hq, Ht), _anchor(ix, Wq, Wt)))
        plans.append(tuple(row))
    return tuple(plans)


def pair_plans(spatial_shapes: Shapes, radius: int = 4,
               max_window: Optional[int] = PALLAS_MAX_WINDOW):
    """``plans[lq][lt]``: the ``PairPlan`` of every pair (cached)."""
    return _pair_plans(_key(spatial_shapes), int(radius), max_window)


@functools.lru_cache(maxsize=32)
def _query_anchors(shapes, radius, max_window, device):
    """Per query (K,) and target level (L): anchor x, anchor y and R + 1 as
    float32 tensors (K, L) on ``device``."""
    plans = _pair_plans(shapes, radius, max_window)
    K, L = sum(h * w for h, w in shapes), len(shapes)
    ax, ay, r1 = (np.zeros((K, L), np.float32) for _ in range(3))
    q0 = 0
    for lq, (Hq, Wq) in enumerate(shapes):
        for lt, plan in enumerate(plans[lq]):
            ay[q0:q0 + Hq * Wq, lt] = np.repeat(plan.anchor_y, Wq)
            ax[q0:q0 + Hq * Wq, lt] = np.tile(plan.anchor_x, Hq)
            r1[q0:q0 + Hq * Wq, lt] = plan.R + 1
        q0 += Hq * Wq
    return tuple(torch.from_numpy(a).to(device) for a in (ax, ay, r1))


def _window_coord(coord, size, anchor, r1):
    """t = (coord * size - 0.5) - anchor + (R + 1), each step rounded in
    fp32, in the order the kernel computes it."""
    return coord * size - 0.5 - anchor + r1


def envelope_mask(
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, h, L, P, K) normalised x
    y: torch.Tensor,  # (bs, h, L, P, K)
    *,
    radius: int = 4,
    max_window: Optional[int] = None,
) -> torch.Tensor:
    """True where a tap's window coordinates lie in ``[0, W - 1]`` on both
    axes, so that the shift-window function samples all of it.  Taps
    outside contribute at most their inside corners there; the dispatcher
    sends them to the exact path.  Same fp32 arithmetic as the JAX
    ``envelope_mask``."""
    shapes = _key(spatial_shapes)
    ax, ay, r1 = _query_anchors(shapes, int(radius), max_window, x.device)
    masks = []
    for lt, (Ht, Wt) in enumerate(shapes):
        tx = _window_coord(x[:, :, lt], Wt, ax[:, lt], r1[:, lt])  # (bs, h, P, K)
        ty = _window_coord(y[:, :, lt], Ht, ay[:, lt], r1[:, lt])
        last = 2 * r1[:, lt]  # W - 1
        masks.append((tx >= 0) & (tx <= last) & (ty >= 0) & (ty <= last))
    return torch.stack(masks, dim=2)


def msda_shift_plain(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, h, L, P, K) fp32 normalised x
    y: torch.Tensor,
    w: torch.Tensor,
    radius: int = 4,
    max_window: Optional[int] = PALLAS_MAX_WINDOW,
    q_chunk: int = 8192,
) -> torch.Tensor:
    """The truncated shift-window MSDA as a direct four-corner gather,
    chunked over queries as ``msda_plain`` is -> (bs, K, h*d).  Any device;
    differentiable by autograd."""
    shapes = _key(spatial_shapes)
    bs, K, h, d = value.shape
    L, P = x.shape[2], x.shape[3]
    dev = value.device
    ax_all, ay_all, r1_all = _query_anchors(shapes, int(radius), max_window, dev)
    table = value.reshape(bs * K * h, d)
    shape5 = (1, 1, 1, L, 1)
    widths = torch.tensor([ww for _, ww in shapes], dtype=torch.float32, device=dev).view(shape5)
    heights = torch.tensor([hh for hh, _ in shapes], dtype=torch.float32, device=dev).view(shape5)
    start = torch.tensor(np.cumsum([0] + [hh * ww for hh, ww in shapes[:-1]]), device=dev).view(shape5)
    b_off = (torch.arange(bs, device=dev) * K).view(bs, 1, 1, 1, 1)
    head = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    xq, yq, wq = (a.permute(0, 4, 1, 2, 3) for a in (x, y, w))  # (bs, K, h, L, P)

    out = torch.empty(bs, K, h, d, dtype=value.dtype, device=dev)
    for q0 in range(0, K, q_chunk):
        q1 = min(K, q0 + q_chunk)
        ax, ay, r1 = (a[q0:q1].view(1, q1 - q0, 1, L, 1) for a in (ax_all, ay_all, r1_all))
        tx = _window_coord(xq[:, q0:q1], widths, ax, r1)
        ty = _window_coord(yq[:, q0:q1], heights, ay, r1)
        fx, fy = torch.floor(tx), torch.floor(ty)
        frx, fry = tx - fx, ty - fy
        acc = None
        for cdx, cdy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            cx, cy = fx + cdx, fy + cdy  # window cells
            col, row = ax + cx - r1, ay + cy - r1  # target column and row
            valid = ((cx >= 0) & (cx <= 2 * r1) & (cy >= 0) & (cy <= 2 * r1)
                     & (col >= 0) & (col < widths) & (row >= 0) & (row < heights))
            k = start + torch.where(valid, row, 0).long() * widths.long() + torch.where(valid, col, 0).long()
            rows = table[((b_off + k) * h + head).reshape(-1)].view(*k.shape, d).float()
            hx = frx if cdx else 1.0 - frx
            hy = fry if cdy else 1.0 - fry
            cw = hx * hy * valid.float() * wq[:, q0:q1]
            term = rows * cw[..., None]
            acc = term if acc is None else acc + term
        out[:, q0:q1] = acc.sum(dim=(3, 4)).to(value.dtype)
    return out.reshape(bs, K, h * d)


def _span(anchors: np.ndarray, tile: int) -> int:
    """Largest anchor spread (last - first) over the tiles of one axis."""
    return max(int(anchors[min(i + tile, len(anchors)) - 1] - anchors[i])
               for i in range(0, len(anchors), tile))


@functools.lru_cache(maxsize=32)
def _shift_tile_plan(shapes, value_dtype, radius, max_window, head_dim, points, smem_budget):
    plans = _pair_plans(shapes, radius, max_window)
    tiles = msda_tiles.tile_shapes(len(shapes))
    windows, origins = [], []
    for lq, (th, tw) in enumerate(tiles):
        win_row, org_row = [], []
        for lt, (Ht, Wt) in enumerate(shapes):
            p = plans[lq][lt]
            wh = min(Ht, _span(p.anchor_y, th) + p.W)
            ww = min(Wt, _span(p.anchor_x, tw) + p.W)
            # the first query row's (column's) anchor minus R + 1, clamped
            # into the level (the kernel's ShiftGeo::window)
            rows = tuple(int(np.clip(a - (p.R + 1), 0, Ht - wh)) for a in p.anchor_y[::th])
            cols = tuple(int(np.clip(a - (p.R + 1), 0, Wt - ww)) for a in p.anchor_x[::tw])
            win_row.append((wh, ww))
            org_row.append((rows, cols))
        windows.append(tuple(win_row))
        origins.append(tuple(org_row))
    return msda_tiles.plan_for_windows(shapes, value_dtype, tuple(windows), tuple(origins),
                                       head_dim=head_dim, points=points, smem_budget=smem_budget)


def shift_tile_plan(spatial_shapes: Shapes, value_dtype: torch.dtype, radius: int = 4,
                    max_window: Optional[int] = PALLAS_MAX_WINDOW, *, head_dim: int = 32,
                    points: int = 4, smem_budget: Optional[int] = None) -> msda_tiles.TilePlan:
    """K4's tile plan (cached): the encoder kernels' tiles and shared-memory
    layout, each pair's window sized to hold every cell its tiles' queries
    can read (``2R + 3`` around each anchor), origins per tile."""
    return _shift_tile_plan(_key(spatial_shapes), value_dtype, int(radius), max_window,
                            int(head_dim), int(points), smem_budget)


def shift_staged_share(
    plan: msda_tiles.TilePlan,
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, h, L, P, K) normalised x
    y: torch.Tensor,
    w: torch.Tensor,
    radius: int = 4,
    max_window: Optional[int] = PALLAS_MAX_WINDOW,
    q_chunk: int = 8192,
) -> Tuple[int, int]:
    """(corner reads served from shared memory, all corner reads) of the
    truncated function on these taps under K4's ``plan``: the corners that
    contribute (cell in the window, pixel in the level, weight not 0), and
    of those the ones inside a staged window."""
    shapes = _key(spatial_shapes)
    L = len(shapes)
    dev = x.device
    ax_all, ay_all, r1_all = _query_anchors(shapes, int(radius), max_window, dev)
    wy0, wx0, wh, ww, staged = msda_tiles.query_windows(plan, str(dev))
    widths = torch.tensor([w_ for _, w_ in shapes], dtype=torch.float32, device=dev).view(1, 1, L, 1, 1)
    heights = torch.tensor([h_ for h_, _ in shapes], dtype=torch.float32, device=dev).view(1, 1, L, 1, 1)
    served = total = 0
    K = x.shape[-1]
    for q0 in range(0, K, q_chunk):
        q1 = min(K, q0 + q_chunk)
        ax, ay, r1, oy, ox, nh, nw, st = (
            a[q0:q1].T.reshape(1, 1, L, 1, q1 - q0)
            for a in (ax_all, ay_all, r1_all, wy0, wx0, wh, ww, staged))
        fx = torch.floor(_window_coord(x[..., q0:q1], widths, ax, r1))
        fy = torch.floor(_window_coord(y[..., q0:q1], heights, ay, r1))
        live = w[..., q0:q1] != 0
        for cdx, cdy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            cx, cy = fx + cdx, fy + cdy
            col, row = ax + cx - r1, ay + cy - r1
            read = (live & (cx >= 0) & (cx <= 2 * r1) & (cy >= 0) & (cy <= 2 * r1)
                    & (col >= 0) & (col < widths) & (row >= 0) & (row < heights))
            inside = st & (col >= ox) & (col < ox + nw) & (row >= oy) & (row < oy + nh)
            total += int(read.sum().item())
            served += int((read & inside).sum().item())
    return served, total


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built K4 library, with its C signature declared."""
    lib = _build.load("msda_shift_fwd").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.msda_shift_qm_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, ip, ip, ip, ip, ip,
                                      *_msda._PLAN_ARGTYPES, p]
    lib.msda_shift_qm_fwd.restype = i
    return lib


@functools.lru_cache(maxsize=32)
def _host_table(shapes, radius, max_window):
    """The kernel's anchor table: per pair (lq * L + lt) its R and the
    offsets of its row and column anchors in one flat int32 array."""
    plans = _pair_plans(shapes, radius, max_window)
    chunks, R, off_y, off_x = [], [], [], []
    n = 0
    for row in plans:
        for plan in row:
            R.append(plan.R)
            off_y.append(n)
            off_x.append(n + len(plan.anchor_y))
            chunks += [plan.anchor_y, plan.anchor_x]
            n += len(plan.anchor_y) + len(plan.anchor_x)
    return np.concatenate(chunks).astype(np.int32), R, off_y, off_x


@functools.lru_cache(maxsize=32)
def _device_table(shapes, radius, max_window, device) -> torch.Tensor:
    return torch.from_numpy(_host_table(shapes, radius, max_window)[0]).to(device)


def _launch_shift(value, spatial_shapes, x, y, w, radius, max_window):
    shapes = _key(spatial_shapes)
    _msda._kernel_checks(value, shapes, x, y, w)
    bs, K, h, d = value.shape
    L, P = x.shape[2], x.shape[3]
    lib = _lib()
    anchors = _device_table(shapes, int(radius), max_window, value.device)
    _, R, off_y, off_x = _host_table(shapes, int(radius), max_window)
    n = len(R)
    plan = shift_tile_plan(shapes, value.dtype, radius, max_window, head_dim=d, points=P)
    out = torch.empty(bs, K, h * d, dtype=value.dtype, device=value.device)
    hs, ws = _msda._level_arrays(shapes)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.msda_shift_qm_fwd(
            value.data_ptr(), x.data_ptr(), y.data_ptr(), w.data_ptr(), anchors.data_ptr(),
            out.data_ptr(), _msda._DTYPE_CODE[value.dtype], bs, K, h, d, L, P, hs, ws,
            (ctypes.c_int * n)(*R), (ctypes.c_int * n)(*off_y), (ctypes.c_int * n)(*off_x),
            *_msda._plan_args(plan), stream,
        )
    _msda._raise_on(err, "msda_shift_qm_fwd")
    _msda.launches_shift += 1
    return out


class _ShiftMSDA(torch.autograd.Function):
    """K4's kernel; its gradient is the exact MSDA backward kernel on
    q-minor strides (the untruncated function's VJP)."""

    @staticmethod
    def forward(ctx, value, x, y, w, spatial_shapes, radius, max_window):
        ctx.save_for_backward(value, x, y, w)
        ctx.spatial_shapes = spatial_shapes
        return _launch_shift(value, spatial_shapes, x, y, w, radius, max_window)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        value, x, y, w = ctx.saved_tensors
        return (*_msda._launch_qm_bwd(value, ctx.spatial_shapes, x, y, w, grad_out), None, None, None)


class CorrectedShiftMSDA(torch.autograd.Function):
    """The exact MSDA as the corrected dispatch (``ops/msda.py:msda_grid_qm``)
    computes it on the card: K4 on the in-envelope taps' weights
    (``mask``), then K3's correction entry on the others' into K4's output
    in place, launched every time (its blocks return at once when the
    device ``count`` is 0), no host read.  The function is the exact MSDA,
    so its gradient is the exact backward kernel on q-minor strides with
    the full weights, one launch."""

    @staticmethod
    def forward(ctx, value, x, y, w, mask, count, spatial_shapes, radius, max_window):
        ctx.save_for_backward(value, x, y, w)
        ctx.spatial_shapes = spatial_shapes
        out = _launch_shift(value, spatial_shapes, x, y, torch.where(mask, w, 0.0), radius, max_window)
        return _msda._launch_correction(value, spatial_shapes, x, y, torch.where(mask, 0.0, w), count, out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_out):
        value, x, y, w = ctx.saved_tensors
        grads = _msda._launch_qm_bwd(value, ctx.spatial_shapes, x, y, w, grad_out)
        return (*grads, None, None, None, None, None)


def msda_grid_shift_qm(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    x: torch.Tensor,  # (bs, h, L, P, K) fp32 normalised x
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    radius: int = 4,
    max_window: Optional[int] = PALLAS_MAX_WINDOW,
) -> torch.Tensor:
    """The shift-window MSDA, truncated to each tap's window -> (bs, K,
    h*d).  ``max_window=None`` is the JAX ``impl="grid"`` (no coarse-pair
    escape); the default is its ``impl="grid_pallas"``."""
    _msda._check_qm(value, spatial_shapes, x, y, w)
    if _msda._route(value) == "cpu":
        return msda_shift_plain(value, spatial_shapes, x, y, w, radius, max_window)
    return _ShiftMSDA.apply(value, x, y, w, _key(spatial_shapes), int(radius), max_window)


def msda_grid_shift(
    value: torch.Tensor,  # (bs, K, h, d)
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,  # (bs, Q=K, h, L, P, 2) fp32 normalised
    attention_weights: torch.Tensor,  # (bs, Q=K, h, L, P) fp32
    *,
    radius: int = 4,
) -> torch.Tensor:
    """The reference-layout wrapper over ``msda_grid_shift_qm`` -> (bs, K,
    h*d): the JAX ``msda_grid_shift``, the truncated shift-window function
    without the coarse-pair escape (``max_window=None``, the JAX
    ``impl="grid"``).  The queries must be the key grid (Q = K); raises
    ``ValueError`` otherwise.  On the card it launches K4; on the CPU it
    runs ``msda_shift_plain``."""
    loc = sampling_locations
    if loc.dim() != 6 or loc.shape[1] != value.shape[1]:
        raise ValueError(f"msda_grid_shift takes grid queries, sampling_locations (bs, K={value.shape[1]}, h, L, "
                         f"P, 2); got {tuple(loc.shape)}")
    qm = loc.permute(0, 2, 3, 4, 5, 1)  # (bs, h, L, P, 2, K)
    return msda_grid_shift_qm(value, spatial_shapes, qm[..., 0, :].contiguous(), qm[..., 1, :].contiguous(),
                              attention_weights.permute(0, 2, 3, 4, 1).contiguous(), radius=radius,
                              max_window=None)
