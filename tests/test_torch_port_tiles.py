"""The tile plan of the port's encoder MSDA kernels
(``codetr_torch/ops/msda_tiles.py``) against the JAX package's windowed
kernel geometry and against brute force, on the CPU.

The tiled CUDA kernels (``csrc/msda_fwd.cu:msda_packed_fwd_levels`` and
``msda_qm_fwd``, ``csrc/msda_bwd.cu:msda_packed_bwd``) run only on the card
(``test_torch_port_cuda.py``); here the plan they read is checked: every
query in exactly one tile, every window inside its level and the budget,
the halo property, the window origins against the JAX
``_win_start_y``, the staged share against a count tap by tap, the q-minor
entry's plan (K1's) and its staged pairs at the three grid-query sizes, and
a numpy model of the kernels' window reads (corner offsets and in-window
masks as ``csrc/msda_tiles.cuh`` computes them, coordinates read packed or
q-minor) against the plain MSDA and, q-minor, the JAX K3 (``msda_win_qm``
in interpret mode) on its in-envelope taps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.ops.msda_win import (_tile_shape_for_level, _win_geometry, _win_start_y, msda_win_qm,
                                     win_envelope_mask)
from codetr_torch.ops import msda as port_msda
from codetr_torch.ops import msda_tiles
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


def level_shapes(h, w):
    """Neck level sizes for an h x w input (strides 4..32, then a stride-2
    conv), as chip_smoke.py and the model compute them."""
    shapes = [(-(-h // s), -(-w // s)) for s in (4, 8, 16, 32)]
    hh, ww = shapes[-1]
    return tuple(shapes + [((hh - 1) // 2 + 1, (ww - 1) // 2 + 1)])


SERVING = level_shapes(768, 1152)  # K = 73,656
R50 = level_shapes(608, 608)  # K = 30,785, a 10x10 last level
TINY = ((13, 21), (7, 11), (4, 6), (2, 3))  # odd, every level below a (16, 16) tile
GATE = level_shapes(1280, 1920)  # the MSDA gate's size, K = 204,600 (a 20x30 last level)
SHAPE_SETS = {"768x1152": SERVING, "608x608": R50, "tiny": TINY}
DTYPES = (torch.float32, torch.bfloat16)


def all_plans(shapes):
    for dtype in DTYPES:
        for backward in (False, True):
            yield msda_tiles.encoder_tile_plan(shapes, dtype, backward=backward)


def tiles_in_kernel_order(plan):
    """(lq, first row, first column, rows, cols) of each block's tile, in the
    order of the kernels' ``tile_coord``: query levels in turn, tiles
    row-major."""
    out = []
    for lq, (Hq, Wq) in enumerate(plan.shapes):
        th, tw = plan.tiles[lq]
        ny, nx = plan.grid(lq)
        for t in range(ny * nx):
            ty, tx = divmod(t, nx)
            out.append((lq, ty * th, tx * tw, min(th, Hq - ty * th), min(tw, Wq - tx * tw)))
    return out


@pytest.mark.parametrize("name", SHAPE_SETS)
def test_plan_covers_every_query_once(name):
    shapes = SHAPE_SETS[name]
    for plan in all_plans(shapes):
        hits = [np.zeros(s, int) for s in shapes]
        tiles = tiles_in_kernel_order(plan)
        assert len(tiles) == sum(plan.n_tiles)
        for lq, y0, x0, rows, cols in tiles:
            assert rows >= 1 and cols >= 1
            hits[lq][y0:y0 + rows, x0:x0 + cols] += 1
        assert all((h == 1).all() for h in hits)


@pytest.mark.parametrize("name", SHAPE_SETS)
def test_windows_inside_levels_and_budget(name):
    """Each window lies inside its target level for every tile; each staged
    window fits its shared-memory region (the check ``make_tile_plan`` makes
    before a launch), and the block's bytes fit the budget."""
    shapes = SHAPE_SETS[name]
    for plan in all_plans(shapes):
        assert plan.smem_bytes <= msda_tiles.SMEM_BUDGET
        d, e = plan.head_dim, plan.element_size
        for lq, y0, x0, _, _ in tiles_in_kernel_order(plan):
            ty, tx = y0 // plan.tiles[lq][0], x0 // plan.tiles[lq][1]
            th, tw = plan.tiles[lq]
            assert plan.off_b[lq] <= plan.off_acc[lq]
            if not plan.backward:
                assert plan.off_acc[lq] + th * tw * d * 4 <= plan.smem_bytes
            else:  # one int2 per in-window corner, then the tile's fp32 gradient rows
                assert plan.off_acc[lq] + (4 * th * tw * plan.points * 8 + th * tw * d * 4) <= plan.smem_bytes
            for lt, (Ht, Wt) in enumerate(shapes):
                wh, ww = plan.windows[lq][lt]
                wy, wx = plan.window_origin(lq, lt, ty, tx)
                assert 0 <= wy and wy + wh <= Ht and 0 <= wx and wx + ww <= Wt
                if not plan.staged[lq][lt]:
                    continue
                nbytes = wh * ww * d * (4 if plan.backward else e)
                if plan.backward:  # the fp32 value window, then an int count per pixel
                    assert nbytes <= plan.off_b[lq] and wh * ww * 4 <= plan.off_acc[lq] - plan.off_b[lq]
                else:
                    region = plan.off_b[lq] if lt % 2 == 0 else plan.off_acc[lq] - plan.off_b[lq]
                    assert nbytes <= region


@pytest.mark.parametrize("points", [1, 4, 8])
def test_backward_plan_holds_entries_and_gradient_rows(points):
    """The backward's layout at every shape set, both dtypes: the fp32 value
    window, one int count per pixel of the largest staged window, then one
    8-byte entry per in-window corner of a full tile (at least 16 entries:
    the block's scan borrows 128 bytes of the list) and the tile's fp32
    upstream gradient rows, all inside the block's shared memory."""
    for shapes in SHAPE_SETS.values():
        for dtype in DTYPES:
            plan = msda_tiles.encoder_tile_plan(shapes, dtype, points=points, backward=True)
            assert plan.points == points
            for lq, (th, tw) in enumerate(plan.tiles):
                staged_px = [wh * ww for (wh, ww), s in zip(plan.windows[lq], plan.staged[lq]) if s]
                assert plan.off_b[lq] >= max(staged_px, default=0) * plan.head_dim * 4
                assert plan.off_acc[lq] - plan.off_b[lq] >= 4 * max(staged_px, default=0)
                tail = max(4 * th * tw * points, 16) * 8 + th * tw * plan.head_dim * 4
                assert plan.off_acc[lq] + tail <= plan.smem_bytes <= msda_tiles.SMEM_BUDGET


def test_serving_plan_stages_every_pair_of_the_finest_query_level():
    """lq0 holds ~75% of the 768x1152 queries (55,296 of 73,656); all its
    pairs fit, in both kernels and both dtypes."""
    for plan in all_plans(SERVING):
        assert all(plan.staged[0])
        assert plan.tiles[0] == (16, 16)
    assert sum(h * w for h, w in SERVING[:1]) == 55_296


@pytest.mark.parametrize("name", ["768x1152", "608x608"])
def test_tiles_and_windows_match_the_jax_kernel(name):
    """The default tiles are the JAX windowed kernel's
    (``_tile_shape_for_level``), the window heights its ``_win_geometry``'s
    at the same halo, and every window origin, on both axes, its
    ``_win_start_y`` for the same tile, size and halo."""
    shapes = SHAPE_SETS[name]
    L = len(shapes)
    plan = msda_tiles.encoder_tile_plan(shapes, torch.float32)
    for lq, (Hq, Wq) in enumerate(shapes):
        assert plan.tiles[lq] == _tile_shape_for_level(lq, L)
        _, jax_win = _win_geometry(lq, shapes, msda_tiles.HALO)
        assert [wh for wh, _ in plan.windows[lq]] == [wh for wh, _ in jax_win]
        th, tw = plan.tiles[lq]
        ny, nx = plan.grid(lq)
        for lt, (Ht, Wt) in enumerate(shapes):
            wh, ww = plan.windows[lq][lt]
            want_y = [int(_win_start_y(t, th, Hq, Ht, msda_tiles.HALO, wh)) for t in range(ny)]
            want_x = [int(_win_start_y(t, tw, Wq, Wt, msda_tiles.HALO, ww)) for t in range(nx)]
            assert [plan.window_origin(lq, lt, t, 0)[0] for t in range(ny)] == want_y
            assert [plan.window_origin(lq, lt, 0, t)[1] for t in range(nx)] == want_x


def random_pyramid(rng):
    h, w = int(rng.integers(3, 90)), int(rng.integers(3, 90))
    shapes = [(h, w)]
    for _ in range(int(rng.integers(0, 4))):
        h, w = -(-h // 2), -(-w // 2)
        shapes.append((h, w))
    return tuple(shapes)


@pytest.mark.parametrize("seed", range(4))
def test_halo_property(seed):
    """On random pyramids and halos: any tap whose corners lie inside the
    level within ``halo`` pixels of its tile's projected footprint (target
    pixels floor(first * nt / nq) .. ceil(end * nt / nq) - 1 on each axis)
    falls inside the tile's window."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        shapes = random_pyramid(rng)
        halo = int(rng.integers(0, 7))
        plan = msda_tiles.encoder_tile_plan(shapes, torch.float32, halo, head_dim=1)
        for lq, y0, x0, rows, cols in tiles_in_kernel_order(plan):
            (Hq, Wq), (th, tw) = shapes[lq], plan.tiles[lq]
            for lt, (Ht, Wt) in enumerate(shapes):
                wy, wx = plan.window_origin(lq, lt, y0 // th, x0 // tw)
                wh, ww = plan.windows[lq][lt]
                for first, n, nq, nt, start, size in ((y0, rows, Hq, Ht, wy, wh), (x0, cols, Wq, Wt, wx, ww)):
                    # the corners' range: the footprint plus the halo, inside the level
                    lo = max(0, first * nt // nq - halo)
                    hi = min(nt - 1, -(-(first + n) * nt // nq) - 1 + halo)
                    assert start <= lo and hi < start + size


def test_plan_rejects_what_the_kernels_cannot_take():
    with pytest.raises(ValueError, match="levels"):
        msda_tiles.encoder_tile_plan(((4, 4),) * 9, torch.float32)
    with pytest.raises(TypeError):
        msda_tiles.encoder_tile_plan(TINY, torch.float16)
    with pytest.raises(ValueError, match="accumulator"):
        msda_tiles.encoder_tile_plan(TINY, torch.float32, smem_budget=16 * 16 * 32 * 4 - 1)


def test_smaller_budget_reads_some_pairs_directly():
    """A budget that holds the small windows and not the large ones stages
    the small ones, and each staged layout still fits."""
    plan = msda_tiles.encoder_tile_plan(SERVING, torch.float32, smem_budget=60_000)
    flat = [s for row in plan.staged for s in row]
    assert any(flat) and not all(flat)
    assert plan.smem_bytes <= 60_000
    arrays = plan.c_arrays()
    L = len(SERVING)
    assert arrays["staged"][1 * L + 4] == int(plan.staged[1][4])
    assert arrays["win_w"][2 * L + 0] == plan.windows[2][0][1]


def grid_taps(rng, shapes, h=2, P=3, halo=5):
    """Grid-query taps (1, K, h, L, P): reference point + up to halo + 3 px,
    10% far, 20% on pixel centres, some weights exactly 0."""
    K, L = sum(a * b for a, b in shapes), len(shapes)
    refs = np.concatenate([
        np.stack(np.meshgrid((np.arange(w) + 0.5) / w, (np.arange(hh) + 0.5) / hh, indexing="xy"), -1).reshape(-1, 2)
        for hh, w in shapes
    ])
    size = np.asarray([[w, hh] for hh, w in shapes], np.float64)[:, None, :]
    loc = refs[None, :, None, None, None, :] + rng.uniform(-halo - 3, halo + 3, (1, K, h, L, P, 2)) / size
    far = rng.random((1, K, h, L, P)) < 0.1
    loc[far] = rng.uniform(-1.0, 2.0, (int(far.sum()), 2))
    exact = rng.random((1, K, h, L, P)) < 0.2
    loc = np.where(exact[..., None], (np.round(loc * size - 0.5) + 0.5) / size, loc).astype(np.float32)
    w = rng.uniform(0, 1, (1, K, h, L, P)).astype(np.float32)
    w[rng.random(w.shape) < 0.1] = 0.0
    return loc, w


def tap_tile_windows(plan):
    """Per query key: (lq, tile row, tile column)."""
    out = []
    for lq, (Hq, Wq) in enumerate(plan.shapes):
        th, tw = plan.tiles[lq]
        for qy in range(Hq):
            for qx in range(Wq):
                out.append((lq, qy // th, qx // tw))
    return out


@pytest.mark.parametrize("smem_budget", [msda_tiles.SMEM_BUDGET, 30_000])
def test_staged_share_matches_brute_force(smem_budget):
    shapes = ((29, 37), (15, 19), (8, 10))  # the finest level wider than its windows
    loc, w = grid_taps(np.random.default_rng(5), shapes)
    plan = msda_tiles.encoder_tile_plan(shapes, torch.float32, smem_budget=smem_budget, head_dim=8)
    x, y, wt = (torch.from_numpy(a) for a in (loc[..., 0], loc[..., 1], w))
    got = msda_tiles.staged_share(plan, x, y, wt, q_chunk=37)
    served = total = 0
    owner = tap_tile_windows(plan)
    for q in range(loc.shape[1]):
        lq, ty, tx = owner[q]
        for head in range(loc.shape[2]):
            for lt, (Ht, Wt) in enumerate(shapes):
                wy, wx = plan.window_origin(lq, lt, ty, tx)
                wh, ww = plan.windows[lq][lt]
                for p in range(loc.shape[4]):
                    if w[0, q, head, lt, p] == 0:
                        continue
                    px = np.float32(np.float32(loc[0, q, head, lt, p, 0]) * np.float32(Wt)) - np.float32(0.5)
                    py = np.float32(np.float32(loc[0, q, head, lt, p, 1]) * np.float32(Ht)) - np.float32(0.5)
                    fx, fy = int(np.floor(px)), int(np.floor(py))
                    for cx, cy in ((fx, fy), (fx + 1, fy), (fx, fy + 1), (fx + 1, fy + 1)):
                        if 0 <= cx < Wt and 0 <= cy < Ht:
                            total += 1
                            served += (plan.staged[lq][lt] and wx <= cx < wx + ww and wy <= cy < wy + wh)
    assert got == (served, total)
    assert 0 < served < total


def packed_reader(loc, w):
    """Tap (key, head, lt, p) -> (x, y, weight) read as ``PackedCoords``
    does: row ``key`` of the packed (1, K, C) array at ``(head * L + lt) * P
    + p``, y and the weight HLP and 2 * HLP further."""
    cpk = pack_np(loc, w)[0]
    _, _, h, L, P = w.shape
    HLP = h * L * P
    return lambda key, head, lt, p: tuple(cpk[key, i * HLP + (head * L + lt) * P + p] for i in range(3))


def qminor_reader(x, y, w):
    """Tap (key, head, lt, p) -> (x, y, weight) read as ``QminorCoords``
    does: the flat (1, h, L, P, K) planes at ``((head * L + lt) * P + p) * K
    + key``."""
    _, h, L, P, K = x.shape
    flat = [a.reshape(-1) for a in (x, y, w)]
    return lambda key, head, lt, p: tuple(a[((head * L + lt) * P + p) * K + key] for a in flat)


def pack_np(loc, w):
    bs, K = w.shape[:2]
    return np.concatenate([loc[..., 0].reshape(bs, K, -1), loc[..., 1].reshape(bs, K, -1),
                           w.reshape(bs, K, -1)], -1)


def window_model(value, shapes, read_tap, h, P, plan):
    """A numpy model of the tiled kernels' reads (``csrc/msda_tiles.cuh``):
    per tile and target level, the window copied out of the value, each
    tap's coordinates from ``read_tap``, its first-corner key ``r00`` and
    window pixel ``s00`` and its corner masks as ``tap_geometry`` computes
    them, and each corner read from the window (offsets 0, 1, win_w, win_w +
    1) or from the value (offsets 0, 1, Wt, Wt + 1) -> (bs, K, h*d), and the
    count of window reads."""
    _, K, _, d = value.shape
    starts = np.cumsum([0] + [a * b for a, b in shapes])
    out = np.zeros((1, K, h, d), np.float64)
    owner = tap_tile_windows(plan)
    window_reads = 0
    for q in range(K):
        lq, ty, tx = owner[q]
        for lt, (Ht, Wt) in enumerate(shapes):
            wy, wx = plan.window_origin(lq, lt, ty, tx)
            wh, ww = plan.windows[lq][lt]
            rows = starts[lt] + (wy + np.arange(wh))[:, None] * Wt + wx + np.arange(ww)[None, :]
            win = value[0, rows.reshape(-1)]  # (wh * ww, h, d): pixel-major, as staged
            for head in range(h):
                for p in range(P):
                    lx, ly, a = read_tap(q, head, lt, p)
                    px = np.float32(np.float32(lx) * np.float32(Wt)) - np.float32(0.5)
                    py = np.float32(np.float32(ly) * np.float32(Ht)) - np.float32(0.5)
                    fx, fy = np.floor(px), np.floor(py)
                    vx0, vx1 = 0 <= fx <= Wt - 1, -1 <= fx <= Wt - 2
                    vy0, vy1 = 0 <= fy <= Ht - 1, -1 <= fy <= Ht - 2
                    if not ((vx0 or vx1) and (vy0 or vy1)):
                        continue
                    tx_, ty_ = px - fx, py - fy
                    x0, y0 = int(fx), int(fy)
                    r00 = starts[lt] + y0 * Wt + x0
                    cx, cy = x0 - wx, y0 - wy
                    ix0, ix1 = 0 <= cx < ww, -1 <= cx < ww - 1
                    iy0, iy1 = 0 <= cy < wh, -1 <= cy < wh - 1
                    s00 = cy * ww + cx
                    for valid, inside, s_off, r_off, hat in (
                        (vx0 and vy0, ix0 and iy0, 0, 0, (1 - tx_) * (1 - ty_)),
                        (vx1 and vy0, ix1 and iy0, 1, 1, tx_ * (1 - ty_)),
                        (vx0 and vy1, ix0 and iy1, ww, Wt, (1 - tx_) * ty_),
                        (vx1 and vy1, ix1 and iy1, ww + 1, Wt + 1, tx_ * ty_),
                    ):
                        if not valid:
                            continue
                        staged = plan.staged[lq][lt] and inside
                        row = win[s00 + s_off, head] if staged else value[0, r00 + r_off, head]
                        window_reads += staged
                        out[0, q, head] += hat * a * row
    return out.reshape(1, K, h * d), window_reads


@pytest.mark.parametrize("layout", ["packed", "qminor"])
@pytest.mark.parametrize("smem_budget", [msda_tiles.SMEM_BUDGET, 12_000])
def test_window_reads_model_matches_plain(smem_budget, layout):
    """The kernels' corner addressing, modelled in numpy, gives the plain
    MSDA, with every pair staged and with some read directly, with the
    coordinates read as K1 reads them (packed) and as K3 does (q-minor,
    against ``msda_reference_qm``)."""
    shapes = TINY
    rng = np.random.default_rng(11)
    loc, w = grid_taps(rng, shapes)
    h, P = w.shape[2], w.shape[4]
    value = rng.standard_normal((1, loc.shape[1], h, 8)).astype(np.float32)
    plan = msda_tiles.encoder_tile_plan(shapes, torch.float32, smem_budget=smem_budget, head_dim=8,
                                        points=P)
    x, y, wq = (np.ascontiguousarray(np.moveaxis(a, 1, -1)) for a in (loc[..., 0], loc[..., 1], w))
    reader = packed_reader(loc, w) if layout == "packed" else qminor_reader(x, y, wq)
    got, reads = window_model(value, shapes, reader, h, P, plan)
    if layout == "packed":
        want = port_msda.multi_scale_deformable_attention_plain(
            torch.from_numpy(value), shapes, torch.from_numpy(loc), torch.from_numpy(w)).numpy()
    else:
        want = port_msda.msda_reference_qm(torch.from_numpy(value), shapes,
                                           *(torch.from_numpy(a) for a in (x, y, wq))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))
    served, _ = msda_tiles.staged_share(plan, *(torch.from_numpy(a) for a in (loc[..., 0], loc[..., 1], w)))
    assert reads >= served > 0


def test_qminor_window_reads_model_matches_jax_k3():
    """The q-minor reads against the JAX K3 itself (``msda_win_qm``, the
    Pallas kernel in interpret mode) on the taps inside its window envelope
    (the others' weights zeroed), at a pyramid whose finest level runs K3's
    ``pallas_call``."""
    shapes = ((40, 40), (20, 20), (10, 10))
    rng = np.random.default_rng(12)
    loc, w = grid_taps(rng, shapes, halo=2)
    h, P = w.shape[2], w.shape[4]
    value = rng.standard_normal((1, loc.shape[1], h, 8)).astype(np.float32)
    x, y, wq = (np.ascontiguousarray(np.moveaxis(a, 1, -1)) for a in (loc[..., 0], loc[..., 1], w))
    inside = np.asarray(win_envelope_mask(shapes, jnp.asarray(x), jnp.asarray(y), radius=4))
    w_in = np.where(inside, wq, 0).astype(np.float32)
    assert 0 < inside.mean() < 1
    plan = msda_tiles.encoder_tile_plan(shapes, torch.float32, head_dim=8, points=P)
    got, _ = window_model(value, shapes, qminor_reader(x, y, w_in), h, P, plan)
    want = np.asarray(msda_win_qm(jnp.asarray(value), shapes, jnp.asarray(x), jnp.asarray(y),
                                  jnp.asarray(w_in), radius=4, interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


# The q-minor entry (K3) runs on K1's forward plan: its coordinates go
# straight to registers, so no shared-memory region is added for them.
# Staged (lq, lt) pairs, per query level, at each grid-query size.
QM_STAGED = {
    ("768x1152", torch.float32): ((1, 1, 1, 1, 1), (0, 1, 1, 1, 1), (0, 0, 1, 1, 1), (0, 0, 1, 1, 1),
                                  (0, 0, 0, 1, 1)),
    ("768x1152", torch.bfloat16): ((1, 1, 1, 1, 1), (1, 1, 1, 1, 1), (0, 1, 1, 1, 1), (0, 1, 1, 1, 1),
                                   (0, 0, 1, 1, 1)),
    ("608x608", torch.float32): ((1, 1, 1, 1, 1), (0, 1, 1, 1, 1), (0, 0, 1, 1, 1), (0, 0, 1, 1, 1),
                                 (0, 0, 1, 1, 1)),
    ("1280x1920", torch.float32): ((1, 1, 1, 1, 1), (0, 1, 1, 1, 1), (0, 0, 1, 1, 1), (0, 0, 1, 1, 1),
                                   (0, 0, 0, 1, 1)),
    ("1280x1920", torch.bfloat16): ((1, 1, 1, 1, 1), (1, 1, 1, 1, 1), (0, 1, 1, 1, 1), (0, 1, 1, 1, 1),
                                    (0, 0, 1, 1, 1)),
}


@pytest.mark.parametrize("size,dtype", list(QM_STAGED), ids=lambda v: str(v).split(".")[-1])
def test_qminor_plan_stages_these_pairs(size, dtype):
    """K3's plan at 768x1152, 608x608 and the gate's 1280x1920: the pairs
    it stages (every pair of the finest query level, which holds ~75% of
    the queries), its layout inside the budget, and the share of the
    queries whose every pair is staged."""
    shapes = {"768x1152": SERVING, "608x608": R50, "1280x1920": GATE}[size]
    plan = msda_tiles.encoder_tile_plan(shapes, dtype, head_dim=32, points=4)
    assert tuple(tuple(int(v) for v in row) for row in plan.staged) == QM_STAGED[size, dtype]
    assert plan.smem_bytes <= msda_tiles.SMEM_BUDGET
    for lq, (th, tw) in enumerate(plan.tiles):
        assert plan.off_acc[lq] + th * tw * 32 * 4 <= plan.smem_bytes
    K = sum(a * b for a, b in shapes)
    assert shapes[0][0] * shapes[0][1] / K > 0.74
