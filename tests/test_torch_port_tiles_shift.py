"""The tile plan of the shift-window kernel K4 (``csrc/msda_shift_fwd.cu``,
plan ``codetr_torch/ops/msda_grid.py:shift_tile_plan``) on the CPU.

K4 runs on the encoder kernels' query tiles with windows of its own: each
pair's window holds every cell (``anchor + c - (R + 1)``, c in [0, W - 1])
of every query of each tile, clipped to the level.  Checked here with the
anchors taken from the JAX package (its ``_AxisPlan``, and the coarse-pair
escape's rational anchors): the windows hold every cell, lie inside their
levels and the budget, and a numpy model of the kernel's tiled reads
(window origins, cells, truncation and corner masks as ``ShiftGeo``
computes them) gives ``msda_shift_plain`` and the JAX
``msda_grid_shift_qm``, serving every corner of a staged pair from its
window.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.ops.msda_grid import _AxisPlan
from codetr_tpu.ops.msda_grid import msda_grid_shift_qm as jax_msda_grid_shift_qm
from codetr_torch.ops import msda_grid, msda_tiles

from test_torch_port_grid import wild_inputs
from test_torch_port_tiles import R50, SERVING, tiles_in_kernel_order
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


def jax_anchors(nq, nt, R, coarse):
    """Anchor of each query index on one axis, from the JAX package: the
    coarse-pair escape's ``floor((i + 0.5) * nt / nq - 0.5)``
    (``msda_pallas._coarse_pair_xla``), else window cell 0 of ``_AxisPlan``
    plus R + 1."""
    i = np.arange(nq)
    if coarse:
        return np.floor((i + 0.5) * (nt / nq) - 0.5).astype(np.int64)
    ap = _AxisPlan(nq, nt, R)
    return (ap.sigma_i * i + ap.s0) // ap.repeat - ap.pad + R + 1


@pytest.mark.parametrize("max_window", [31, 13, None])
@pytest.mark.parametrize("radius", [4, 5])
@pytest.mark.parametrize("name", ["768x1152", "608x608"])
def test_shift_plan_windows_hold_every_cell(name, radius, max_window):
    """Every cell of every query of a tile that lies in the level lies in
    the tile's window of the pair (so a staged pair never reads global
    memory); each window lies inside its level; the origins are the
    kernel's ``clamp(first anchor - (R + 1), 0, n - win)``; both dtypes'
    layouts fit the budget."""
    shapes = {"768x1152": SERVING, "608x608": R50}[name]
    pairs = msda_grid.pair_plans(shapes, radius, max_window)
    for dtype in (torch.float32, torch.bfloat16):
        plan = msda_grid.shift_tile_plan(shapes, dtype, radius, max_window)
        assert plan.smem_bytes <= msda_tiles.SMEM_BUDGET
        assert plan.tiles == msda_tiles.tile_shapes(len(shapes))
        for lq, (Hq, Wq) in enumerate(shapes):
            th, tw = plan.tiles[lq]
            for lt, (Ht, Wt) in enumerate(shapes):
                pp = pairs[lq][lt]
                wh, ww = plan.windows[lq][lt]
                for nq, nt, tile, win, anchors, axis in ((Hq, Ht, th, wh, pp.anchor_y, 0),
                                                         (Wq, Wt, tw, ww, pp.anchor_x, 1)):
                    want = jax_anchors(nq, nt, pp.R, pp.coarse)
                    np.testing.assert_array_equal(anchors, want)
                    t = np.arange(nq) // tile
                    origin = np.asarray([plan.window_origin(lq, lt, *((k, 0) if axis == 0 else (0, k)))[axis]
                                         for k in range(t[-1] + 1)])
                    np.testing.assert_array_equal(origin, np.clip(want[::tile] - (pp.R + 1), 0, nt - win))
                    assert 1 <= win <= nt and (origin >= 0).all() and (origin + win <= nt).all()
                    lo = np.maximum(want - (pp.R + 1), 0)
                    hi = np.minimum(want + pp.R + 1, nt - 1)
                    some = lo <= hi  # a query with a cell in the level
                    assert (origin[t][some] <= lo[some]).all() and (hi[some] < origin[t][some] + win).all()


def test_shift_plan_pairs_at_768x1152():
    """At 768x1152 (radius 5, ``max_window`` 31, fp32) the finest query
    level stages every pair; lq4 -> lt0 spans 65 x 129 pixels (the 2^4
    scale times the tile, plus W = 17) and is read from global memory."""
    plan = msda_grid.shift_tile_plan(SERVING, torch.float32, 5, 31)
    assert all(plan.staged[0])
    assert plan.windows[4][0] == (65, 129) and not plan.staged[4][0]
    assert sum(map(sum, plan.staged)) == 17


def shift_model(value, shapes, x, y, w, radius, max_window, plan):
    """A numpy model of K4's tiled reads: per tile and target level the
    window at the plan's origin copied out of the value; each tap's window
    coordinate ``t = (loc * size - 0.5) - anchor + (R + 1)`` per axis, its
    cells and their pixels, the truncated corner mask and the in-window
    mask as ``ShiftGeo::tap`` computes them; a tap whose contributing
    corners all lie in a staged window reads them there, any other from
    the value -> (1, K, h*d), (window reads, global reads of staged pairs,
    all corner reads)."""
    _, K, h, d = value.shape
    P = x.shape[3]
    pairs = msda_grid.pair_plans(shapes, radius, max_window)
    starts = np.cumsum([0] + [a * b for a, b in shapes])
    out = np.zeros((1, K, h, d), np.float64)
    win_reads = staged_global = total = 0
    f32 = np.float32
    for lq, y0, x0, rows, cols in tiles_in_kernel_order(plan):
        th, tw = plan.tiles[lq]
        for lt, (Ht, Wt) in enumerate(shapes):
            pp = pairs[lq][lt]
            oy, ox = plan.window_origin(lq, lt, y0 // th, x0 // tw)
            wh, ww = plan.windows[lq][lt]
            for r in range(rows):
                for c in range(cols):
                    q = starts[lq] + (y0 + r) * shapes[lq][1] + x0 + c
                    for head in range(h):
                        for p in range(P):
                            a = w[0, head, lt, p, q]
                            axes = []
                            for loc, size, anchor in ((x[0, head, lt, p, q], Wt, pp.anchor_x[x0 + c]),
                                                      (y[0, head, lt, p, q], Ht, pp.anchor_y[y0 + r])):
                                t = (f32(f32(loc) * f32(size)) - f32(0.5) - f32(anchor)) + f32(pp.R + 1)
                                f = np.floor(t)
                                idx0 = int(anchor + f - (pp.R + 1)) if -1 <= f <= pp.W - 1 else 0
                                v0 = 0 <= f <= pp.W - 1 and 0 <= idx0 < size
                                v1 = -1 <= f <= pp.W - 2 and 0 <= idx0 + 1 < size
                                axes.append((v0, v1, idx0, t - f))
                            (vx0, vx1, ix, fx), (vy0, vy1, iy, fy) = axes
                            corners = [(vx0 and vy0, 0, 0, (1 - fx) * (1 - fy)),
                                       (vx1 and vy0, 1, 0, fx * (1 - fy)),
                                       (vx0 and vy1, 0, 1, (1 - fx) * fy),
                                       (vx1 and vy1, 1, 1, fx * fy)]
                            live = [k for k in corners if k[0]]
                            inside = [oy <= iy + dy < oy + wh and ox <= ix + dx < ox + ww
                                      for _, dx, dy, _ in live]
                            from_window = plan.staged[lq][lt] and bool(live) and all(inside)
                            for (_, dx, dy, hat) in live:
                                px, py = ix + dx, iy + dy
                                if from_window:
                                    win = value[0, starts[lt] + (oy + np.arange(wh))[:, None] * Wt
                                                + ox + np.arange(ww)[None, :]]
                                    row = win[py - oy, px - ox, head]
                                    win_reads += 1
                                else:
                                    row = value[0, starts[lt] + py * Wt + px, head]
                                    staged_global += plan.staged[lq][lt]
                                total += a != 0
                                out[0, q, head] += hat * a * row
    return out.reshape(1, K, h * d), (win_reads, staged_global, total)


@pytest.mark.parametrize("radius,max_window,smem_budget", [
    (1, 31, None),  # idealised anchors, every pair staged
    (1, 7, None),  # cross-level pairs (W = 9) take the coarse-pair escape
    (1, 31, 12_000),  # a budget that leaves some pairs to global memory
])
def test_shift_window_reads_model_matches_plain_and_jax(radius, max_window, smem_budget):
    """The modelled tiled reads give ``msda_shift_plain`` (the truncated
    function, wild taps far outside their windows included) and, without
    the escape, the JAX ``msda_grid_shift_qm``; every corner of a staged
    pair comes from its window, and ``shift_staged_share`` counts the same
    reads."""
    shapes = ((20, 19), (10, 10), (5, 5))
    value, x, y, w = wild_inputs(3, shapes, radius=radius, jitter=radius + 0.5)
    plan = msda_grid.shift_tile_plan(shapes, torch.float32, radius, max_window, head_dim=value.shape[3],
                                     points=x.shape[3], smem_budget=smem_budget)
    flat = [s for row in plan.staged for s in row]
    assert any(flat) and (all(flat) if smem_budget is None else not all(flat))
    got, (win_reads, staged_global, total) = shift_model(value, shapes, x, y, w, radius, max_window, plan)
    t = (torch.from_numpy(a) for a in (value, x, y, w))
    want = msda_grid.msda_shift_plain(*(lambda v, *c: (v, shapes, *c))(*t), radius, max_window).numpy()
    scale = max(1.0, np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    if max_window == 31 and radius == 1:  # W = 5 / 9 <= 31: the JAX impl="grid" computes it
        jax_out = np.asarray(jax_msda_grid_shift_qm(*(jnp.asarray(a) for a in (value,)), shapes,
                                                    *(jnp.asarray(a) for a in (x, y, w)), radius=radius))
        np.testing.assert_allclose(got, jax_out, rtol=0, atol=1e-5 * scale)
    assert staged_global == 0 and win_reads > 0
    served, counted = msda_grid.shift_staged_share(plan, shapes, *(torch.from_numpy(a) for a in (x, y, w)),
                                                   radius, max_window)
    assert (served, counted) == (win_reads, total)
