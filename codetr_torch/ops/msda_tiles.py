"""Tile plan of the encoder MSDA kernels: the packed entries of
``csrc/msda_fwd.cu`` (``msda_packed_fwd_levels``, K1) and ``csrc/msda_bwd.cu``
(``msda_packed_bwd``, K2), the q-minor entry ``msda_qm_fwd`` (K3), and,
with windows of its own, the shift-window kernel
``csrc/msda_shift_fwd.cu`` (K4, ``ops/msda_grid.py:shift_tile_plan``).

The encoder's queries are the level-concatenated pixel grid, so a tile of
same-level queries samples a bounded window of each target level.  The plan
cuts each query level ``lq`` into tiles of ``(th, tw)`` queries; every
query of the grid lies in exactly one tile.  For each (query level, target
level) pair it fixes a window of ``(WinH, WinW)`` target pixels, placed for
tile ``(ty, tx)`` by the tile's static projection onto the target level (the
JAX package's formula, ``codetr_tpu/ops/msda_win.py:175-179``, on both axes
and without the x floor-to-8 that only Mosaic needs):

    start = clip((t * tile * nt) // nq - halo, 0, nt - win)
    win   = min(nt, ceil(tile * nt / nq) + 2 * halo + 2)

A pair is *staged* if its window fits the block's shared-memory budget: the
kernel copies it into shared memory and serves the corners inside it from
there.  Every other corner, of a tap outside the window or of a pair that is
not staged, is read from global memory in the same kernel, so the result is
exact for any tap.

Shared memory per block (one head of one tile, all in bytes):

- forward: two window regions, one for the even target levels and one for
  the odd ones (the kernel copies level ``lt + 1`` while it samples level
  ``lt``), then an fp32 accumulator of ``th * tw * d`` values;
- backward: the value window of the current target level in fp32 (bf16
  values are converted as they are copied), one int count per window pixel,
  a list of ``4 * th * tw * points`` entries of 8 bytes, one per in-window
  corner of the tile's taps (the kernel sums them per pixel into the value
  gradient), and the tile's upstream gradient rows in fp32.

K3 reads its q-minor coordinates straight into registers (each warp's
loads of one point touch consecutive keys of a tile row), so its plan is
K1's: no shared-memory region for coordinates.  K4 keeps the tiles and the
layout, and places its windows around its anchors (``plan_for_windows``
with per-tile ``origins``).

``encoder_tile_plan`` builds the plan (cached), ``correction_plan`` the
same tiles with no window staged for K3's correction entry;
``staged_share`` counts, for a set of taps, the share of nonzero-weight
corner reads that the plan serves from shared memory (``taps_outside`` the
taps with a corner it does not serve; ``corner_reads`` the masks both
count).  Nothing here needs a card.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Mapping, Sequence, Tuple

import numpy as np
import torch

Shapes = Sequence[Tuple[int, int]]

HALO = 5  # the window's margin around a tile's projection, in target pixels
SMEM_BUDGET = 232_448  # bytes of shared memory one block can use on an H100
# query tile (rows, cols) of each query level; levels past the last take it
TILES = ((16, 16), (8, 16), (8, 16), (8, 8), (4, 8))
MAX_LEVELS = 8  # the kernels' TILE_MAX_LEVELS
_ELEMENT_SIZE = {torch.float32: 4, torch.bfloat16: 2}


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def window_size(tile: int, nq: int, nt: int, halo: int) -> int:
    """Window extent on one axis for a tile of ``tile`` queries on a query
    axis of ``nq`` onto a target axis of ``nt`` (``msda_win.py:160-169``)."""
    span = -(-tile * nt // nq)
    return min(nt, span + 2 * halo + 2)


def window_start(t: int, tile: int, nq: int, nt: int, halo: int, win: int) -> int:
    """Window start on one axis for tile index ``t`` (``msda_win.py:175``)."""
    return int(np.clip((t * tile * nt) // nq - halo, 0, nt - win))


@dataclass(frozen=True)
class TilePlan:
    """One kernel's tiles, windows, staged pairs and shared-memory layout.

    ``windows[lq][lt]`` is ``(WinH, WinW)``; ``staged[lq][lt]`` whether the
    pair's window is copied to shared memory; ``off_b[lq]`` the byte offset
    of the second region (forward: the odd target levels' windows;
    backward: the window pixels' counts), ``off_acc[lq]`` that of the third
    (forward: the accumulator; backward: the entry list); ``smem_bytes`` the
    dynamic shared memory of every block (the largest query level's)."""

    shapes: Tuple[Tuple[int, int], ...]
    halo: int  # 0 in a plan with ``origins``
    backward: bool
    head_dim: int
    points: int
    element_size: int
    tiles: Tuple[Tuple[int, int], ...]
    windows: Tuple[Tuple[Tuple[int, int], ...], ...]
    staged: Tuple[Tuple[bool, ...], ...]
    off_b: Tuple[int, ...]
    off_acc: Tuple[int, ...]
    smem_bytes: int
    # origins[lq][lt] = (row origin per tile row, column origin per tile
    # column); None: the halo formula (``window_start``)
    origins: Tuple[Tuple[Tuple[Tuple[int, ...], Tuple[int, ...]], ...], ...] | None = None

    def grid(self, lq: int) -> Tuple[int, int]:
        """(tiles down, tiles across) of query level ``lq``."""
        (Hq, Wq), (th, tw) = self.shapes[lq], self.tiles[lq]
        return -(-Hq // th), -(-Wq // tw)

    @property
    def n_tiles(self) -> Tuple[int, ...]:
        return tuple(ny * nx for ny, nx in map(self.grid, range(len(self.shapes))))

    def window_origin(self, lq: int, lt: int, ty: int, tx: int) -> Tuple[int, int]:
        """(row, column) of the first target pixel of tile (ty, tx)'s window
        on target level ``lt``."""
        if self.origins is not None:
            rows, cols = self.origins[lq][lt]
            return rows[ty], cols[tx]
        (Hq, Wq), (Ht, Wt) = self.shapes[lq], self.shapes[lt]
        (th, tw), (wh, ww) = self.tiles[lq], self.windows[lq][lt]
        return (window_start(ty, th, Hq, Ht, self.halo, wh),
                window_start(tx, tw, Wq, Wt, self.halo, ww))

    def c_arrays(self) -> dict:
        """The plan as the C entries take it: int lists, pairs at
        ``lq * L + lt``."""
        flat = lambda rows: [v for row in rows for v in row]  # noqa: E731
        return {
            "tile_h": [th for th, _ in self.tiles],
            "tile_w": [tw for _, tw in self.tiles],
            "win_h": flat([[wh for wh, _ in row] for row in self.windows]),
            "win_w": flat([[ww for _, ww in row] for row in self.windows]),
            "staged": [int(s) for s in flat(self.staged)],
            "off_b": list(self.off_b),
            "off_acc": list(self.off_acc),
        }


def _layout(win_bytes, win_px, staged, tail_bytes, backward):
    """(off_b, off_acc, bytes) of one query level for the staged windows;
    ``tail_bytes`` is the forward's accumulator or the backward's entry
    list and upstream gradient rows."""
    def largest(sizes, parity=None):  # of the staged windows (of one parity of lt)
        return _align16(max((n for lt, n in enumerate(sizes) if staged[lt] and parity in (None, lt % 2)),
                            default=0))

    if backward:
        v, c = largest(win_bytes), largest([4 * n for n in win_px])
        return v, v + c, v + c + tail_bytes
    a, b = largest(win_bytes, 0), largest(win_bytes, 1)
    return a, a + b, a + b + tail_bytes


def tile_shapes(num_levels: int) -> Tuple[Tuple[int, int], ...]:
    """The query tile of each query level."""
    return tuple(TILES[min(lq, len(TILES) - 1)] for lq in range(num_levels))


def _stage(shapes, tiles, windows, element_size, smem_budget, head_dim, points, backward, halo,
           origins=None):
    """The plan for given windows: per query level, stage the smallest
    windows first while the block's layout fits the budget."""
    L = len(shapes)
    staged, off_b, off_acc, total = [], [], [], 0
    for lq in range(L):
        th, tw = tiles[lq]
        px = [wh * ww for wh, ww in windows[lq]]
        # the backward stages its windows in fp32 whatever the value's dtype
        win_bytes = [n * head_dim * (4 if backward else element_size) for n in px]
        # the forward's accumulator; the backward's entry list (which also
        # holds its block's scan scratch, 32 ints) and upstream gradient rows
        tail = (max(4 * th * tw * points, 16) * 8 if backward else 0) + th * tw * head_dim * 4
        chosen = [False] * L
        if _layout(win_bytes, px, chosen, tail, backward)[2] > smem_budget:
            raise ValueError(f"query level {lq}: a ({th}, {tw}) tile's accumulator alone exceeds "
                             f"{smem_budget} bytes")
        for lt in sorted(range(L), key=lambda i: (win_bytes[i], i)):
            chosen[lt] = True
            if _layout(win_bytes, px, chosen, tail, backward)[2] > smem_budget:
                chosen[lt] = False
        b_off, a_off, nbytes = _layout(win_bytes, px, chosen, tail, backward)
        staged.append(tuple(chosen))
        off_b.append(b_off)
        off_acc.append(a_off)
        total = max(total, nbytes)
    return TilePlan(shapes, halo, backward, head_dim, points, element_size, tiles, windows,
                    tuple(staged), tuple(off_b), tuple(off_acc), total, origins)


def _check_levels(L: int) -> None:
    if not 1 <= L <= MAX_LEVELS:
        raise ValueError(f"the tiled kernels take 1 to {MAX_LEVELS} levels, got {L}")


@functools.lru_cache(maxsize=64)
def _plan(shapes, element_size, halo, smem_budget, head_dim, points, backward, tiles):
    _check_levels(len(shapes))
    windows = tuple(
        tuple((window_size(th, Hq, Ht, halo), window_size(tw, Wq, Wt, halo)) for Ht, Wt in shapes)
        for (Hq, Wq), (th, tw) in zip(shapes, tiles))
    return _stage(shapes, tiles, windows, element_size, smem_budget, head_dim, points, backward, halo)


def plan_for_windows(
    spatial_shapes: Shapes,
    value_dtype: torch.dtype,
    windows,  # windows[lq][lt] = (WinH, WinW)
    origins,  # origins[lq][lt] = (row origin per tile row, column origin per tile column)
    *,
    head_dim: int = 32,
    points: int = 4,
    smem_budget: int | None = None,
) -> TilePlan:
    """A forward plan on the default tiles with windows and origins given
    per pair (K4's, ``ops/msda_grid.py``); the budget and staging as
    ``encoder_tile_plan``'s.  Each window must lie inside its level."""
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    _check_levels(len(shapes))
    if value_dtype not in _ELEMENT_SIZE:
        raise TypeError(f"value dtype must be float32 or bfloat16, got {value_dtype}")
    budget = SMEM_BUDGET if smem_budget is None else int(smem_budget)
    return _stage(shapes, tile_shapes(len(shapes)), windows, _ELEMENT_SIZE[value_dtype], budget,
                  int(head_dim), int(points), False, 0, origins)


def encoder_tile_plan(
    spatial_shapes: Shapes,
    value_dtype: torch.dtype,
    halo: int = HALO,
    smem_budget: int | None = None,
    *,
    head_dim: int = 32,
    points: int = 4,
    backward: bool = False,
    tiles: Mapping[int, Tuple[int, int]] | None = None,
) -> TilePlan:
    """The tile plan of the encoder forward (or, with ``backward``, the
    backward) kernel for a level set, a value dtype, head dim and points
    per level (cached).  ``smem_budget`` (None: ``SMEM_BUDGET``) bounds a
    block's shared memory.  ``tiles`` overrides the query tile ``(th,
    tw)`` of the query levels it names (``tools/winbench.py --tiles``);
    windows, staging and layout follow from the tiles as for the
    defaults.  A tile whose accumulator alone exceeds the budget raises
    ``ValueError``."""
    if value_dtype not in _ELEMENT_SIZE:
        raise TypeError(f"value dtype must be float32 or bfloat16, got {value_dtype}")
    shapes = tuple((int(h), int(w)) for h, w in spatial_shapes)
    budget = SMEM_BUDGET if smem_budget is None else int(smem_budget)
    chosen = list(tile_shapes(len(shapes)))
    for lq, (th, tw) in (tiles or {}).items():
        if not 0 <= lq < len(shapes) or th < 1 or tw < 1:
            raise ValueError(f"a tile ({th}, {tw}) for query level {lq} of {len(shapes)}")
        chosen[lq] = (int(th), int(tw))
    return _plan(shapes, _ELEMENT_SIZE[value_dtype], int(halo), budget, int(head_dim), int(points),
                 bool(backward), tuple(chosen))


@functools.lru_cache(maxsize=16)
def _unstaged(plan: TilePlan) -> TilePlan:
    L = len(plan.shapes)
    return replace(plan, staged=tuple((False,) * L for _ in range(L)), off_b=(0,) * L, off_acc=(0,) * L,
                   smem_bytes=max(th * tw * plan.head_dim * 4 for th, tw in plan.tiles))


def correction_plan(spatial_shapes: Shapes, value_dtype: torch.dtype, *, head_dim: int = 32,
                    points: int = 4) -> TilePlan:
    """The plan of K3's correction entry (``msda_qm_correction_fwd``):
    ``encoder_tile_plan``'s tiles and windows with no pair staged, so that
    a block's shared memory is its accumulator alone and its few corner
    reads go to global memory (cached)."""
    return _unstaged(encoder_tile_plan(spatial_shapes, value_dtype, head_dim=head_dim, points=points))


@functools.lru_cache(maxsize=16)
def query_windows(plan: TilePlan, device: str) -> Tuple[torch.Tensor, ...]:
    """Per query (K) and target level (L): its tile's window row and column
    origin, height and width (int64), and whether the pair is staged
    (bool), as (K, L) tensors on ``device``."""
    K, L = sum(h * w for h, w in plan.shapes), len(plan.shapes)
    y0, x0, wh, ww = (np.zeros((K, L), np.int64) for _ in range(4))
    staged = np.zeros((K, L), bool)
    q0 = 0
    for lq, (Hq, Wq) in enumerate(plan.shapes):
        th, tw = plan.tiles[lq]
        ny, nx = plan.grid(lq)
        ty = np.repeat(np.arange(Hq) // th, Wq)
        tx = np.tile(np.arange(Wq) // tw, Hq)
        sl = slice(q0, q0 + Hq * Wq)
        for lt in range(L):
            wh[sl, lt], ww[sl, lt] = plan.windows[lq][lt]
            rows = np.asarray([plan.window_origin(lq, lt, t, 0)[0] for t in range(ny)])
            cols = np.asarray([plan.window_origin(lq, lt, 0, t)[1] for t in range(nx)])
            y0[sl, lt], x0[sl, lt] = rows[ty], cols[tx]
            staged[sl, lt] = plan.staged[lq][lt]
        q0 += Hq * Wq
    return tuple(torch.from_numpy(a).to(device) for a in (y0, x0, wh, ww, staged))


def corner_reads(plan: TilePlan, x, y, w, queries: slice | None = None, q_chunk: int = 8192):
    """Per chunk of the queries ``queries`` (a slice of the K grid queries;
    None: all): its first query and, for each of the four corners, (pixel
    column, pixel row, read, read from shared memory), each (bs, q, h, L,
    P).  A read is a corner inside its level of a tap whose weight is not
    0, served if inside a staged window.  Pixel coordinates as the kernels
    compute them (the product rounded first).  ``x``, ``y``, ``w`` as
    ``staged_share`` takes them."""
    L = len(plan.shapes)
    dev = x.device
    windows = query_windows(plan, str(dev))
    shape5 = (1, 1, 1, L, 1)
    widths = torch.tensor([w_ for _, w_ in plan.shapes], device=dev).view(shape5)
    heights = torch.tensor([h_ for h_, _ in plan.shapes], device=dev).view(shape5)
    start, stop, _ = (queries or slice(None)).indices(x.shape[1])
    for q0 in range(start, stop, q_chunk):
        q1 = min(stop, q0 + q_chunk)
        fx = torch.floor(x[:, q0:q1] * widths.float() - 0.5).long()
        fy = torch.floor(y[:, q0:q1] * heights.float() - 0.5).long()
        live = w[:, q0:q1] != 0
        wy0, wx0, wh, ww, staged = (a[q0:q1].view(1, q1 - q0, 1, L, 1) for a in windows)
        corners = []
        for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            cx, cy = fx + dx, fy + dy
            read = live & (cx >= 0) & (cx < widths) & (cy >= 0) & (cy < heights)
            inside = staged & (cx >= wx0) & (cx < wx0 + ww) & (cy >= wy0) & (cy < wy0 + wh)
            corners.append((cx, cy, read, read & inside))
        yield q0, corners


def staged_share(
    plan: TilePlan,
    x: torch.Tensor,  # (bs, K, h, L, P) normalised x of the grid queries
    y: torch.Tensor,  # (bs, K, h, L, P)
    w: torch.Tensor,  # (bs, K, h, L, P) attention weights
    q_chunk: int = 8192,
    queries: slice | None = None,
) -> Tuple[int, int]:
    """(corner reads served from shared memory, all corner reads) of these
    taps under ``plan``: the corners inside their level of the taps whose
    weight is not 0, and of those the ones inside a staged window; of the
    queries ``queries`` (None: all)."""
    served = total = 0
    for _, corners in corner_reads(plan, x, y, w, queries, q_chunk):
        for _, _, read, inside in corners:
            total += int(read.sum().item())
            served += int(inside.sum().item())
    return served, total


def taps_outside(plan: TilePlan, x, y, w, q_chunk: int = 8192, queries: slice | None = None) -> int:
    """The taps (of the queries ``queries``; None: all) with a corner read
    that no staged window serves: the kernel reads it from global memory.
    ``staged_share``'s arguments; the counterpart of the JAX window
    kernel's count of taps outside its envelope."""
    out = 0
    for _, corners in corner_reads(plan, x, y, w, queries, q_chunk):
        missed = functools.reduce(torch.logical_or, [read & ~inside for _, _, read, inside in corners])
        out += int(missed.sum().item())
    return out
