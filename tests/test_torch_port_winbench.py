"""The per-level K1 microbenchmark (``codetr_torch/tools/winbench.py``)
against the JAX package's ``tools/winbench.py``, on the CPU at 64x96 (the
plain version in place of the kernel; every figure a host one):

- its inputs are the JAX tool's construction bit for bit (value, q-minor
  x, y, w, the packed coordinates), drawn with the JAX ``_anchor`` and
  ``pack_coords_qmajor``;
- ``--verify --full --module --iters 1 --trials 1`` prints the JAX keys
  (``name`` / ``ms`` a trial, ``lq`` / ``best_sane_ms`` a level,
  ``verify_max_err`` / ``n_out``, ``full_best_sane_ms``,
  ``module_best_sane_ms``) after a geometry record that is the plan's, and
  a summary last; each level's rows equal the full call's;
- each level's plain rows (``ops/msda.py:msda_packed_level`` on the CPU)
  against the JAX ``msda_reference_qm`` on that level's queries, 1e-5;
- a ``--tiles`` override reaches the plan (windows and staging follow from
  the tile), an oversize tile is refused naming its level;
- the default device raises without a card.

The port runs in one thread (``one_thread``): at these sizes the plain
version's elementwise ops cost more in thread synchronisation than they
gain from more threads.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.ops.msda import msda_reference_qm
from codetr_tpu.ops.msda_grid import _anchor as jax_anchor
from codetr_tpu.ops.msda_win import pack_coords_qmajor as jax_pack
from codetr_torch.ops import msda, msda_tiles
from codetr_torch.tools import winbench

HW = (64, 96)
CPU = ["--height", str(HW[0]), "--width", str(HW[1]), "--device", "cpu", "--iters", "1", "--trials", "1"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_tool_inputs(H, W, jit_px):
    """``tools/winbench.py:86-117`` as the JAX tool runs it."""
    strides = (4, 8, 16, 32, 64)
    shapes = tuple((-(-H // s), -(-W // s)) for s in strides)
    K = sum(hh * ww for hh, ww in shapes)
    h, P, L, d = 8, 4, len(shapes), 32
    rng = np.random.default_rng(0)
    value = jnp.asarray(rng.standard_normal((1, K, h, d)), jnp.bfloat16)
    x = np.zeros((1, h, L, P, K), np.float32)
    y = np.zeros_like(x)
    q0 = 0
    for lq, (Hq, Wq) in enumerate(shapes):
        iy, ix = np.meshgrid(np.arange(Hq), np.arange(Wq), indexing="ij")
        for lt, (Ht, Wt) in enumerate(shapes):
            ay = jax_anchor(iy, Hq, Ht).reshape(-1)
            ax = jax_anchor(ix, Wq, Wt).reshape(-1)
            y[0, :, lt, :, q0:q0 + Hq * Wq] = (ay + rng.uniform(-jit_px, jit_px, (h, P, Hq * Wq)) + 0.5) / Ht
            x[0, :, lt, :, q0:q0 + Hq * Wq] = (ax + rng.uniform(-jit_px, jit_px, (h, P, Hq * Wq)) + 0.5) / Wt
        q0 += Hq * Wq
    w = rng.uniform(0, 1, (1, h, L, P, K)).astype(np.float32)
    w /= w.sum(axis=(2, 3), keepdims=True)
    return shapes, value, x, y, w, jax_pack(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))


@pytest.mark.parametrize("hw,jitter", [(HW, 4.0), ((72, 100), 2.5)])
def test_inputs_are_the_jax_tools(hw, jitter):
    shapes, value, x, y, w, _ = winbench.make_inputs(*hw, jitter)
    j_shapes, j_value, j_x, j_y, j_w, j_cpk = jax_tool_inputs(*hw, jitter)
    assert shapes == j_shapes
    got_bits = torch.from_numpy(value).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(got_bits, np.asarray(j_value).view(np.int16))
    for got, want in ((x, j_x), (y, j_y), (w, j_w)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    cpk = msda.pack_coords_qmajor(*(torch.from_numpy(a) for a in (x, y, w)))
    np.testing.assert_array_equal(cpk.numpy(), np.asarray(j_cpk)[..., :cpk.shape[-1]])


def test_cpu_run_prints_the_jax_keys(capsys):
    result = winbench.main(CPU + ["--lq", "0", "1", "2", "3", "4", "--verify", "--full", "--module"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    geo, summary = lines[0], lines[-1]["summary"]
    plan = msda_tiles.encoder_tile_plan(winbench.level_shapes(*HW), torch.bfloat16)
    assert set(geo) >= {"geometry", "radius", "n/a", "smem_bytes"} and geo["radius"] == 5 and geo["jitter"] == 4.0
    assert geo["smem_bytes"] == plan.smem_bytes and set(geo["n/a"]) == set(winbench.NA)
    for lq in range(5):
        g = geo["geometry"][str(lq)]
        assert g["tile"] == list(plan.tiles[lq]) and g["win"] == [list(wn) for wn in plan.windows[lq]]
        assert g["cells"] == [a * b for a, b in plan.windows[lq]] and g["staged"] == list(plan.staged[lq])
    trials = [r["name"] for r in lines if "name" in r]
    assert trials == ["lq0", "lq1", "lq2", "lq3", "lq4", "full", "module"]
    assert all(r["ms"] > 0 for r in lines if "name" in r)
    verified = [r for r in lines if "verify_max_err" in r]
    assert [r["lq"] for r in verified] == list(range(5)) and all(r["ok"] and r["n_out"] == 0 for r in verified)
    levels = [r for r in lines if "best_sane_ms" in r and "lq" in r]
    for r in levels:
        assert r["best_sane_ms"] > 0 and r["bound_ms"] > 0 and r["bytes"] > 0 and r["n_out"] == 0
        assert r["corner_reads"] >= r["corner_reads_staged"] > 0
    assert sum(r["queries"] for r in levels) == summary["K"]
    assert [r for r in lines if "full_best_sane_ms" in r][0]["full_best_sane_ms"] > 0
    assert [r for r in lines if "module_best_sane_ms" in r][0]["module_best_sane_ms"] > 0
    assert summary["verify_ok"] and summary["rows_equal_full"] and winbench.passed(summary)
    assert summary["sum_levels_ms"] == pytest.approx(sum(summary["levels_best_sane_ms"].values()))
    assert summary["card"] == "cpu" and result["summary"]["sum_levels_ms"] == summary["sum_levels_ms"]


def test_level_rows_match_jax_reference():
    """Each level's rows of K1's level entry (the plain version on the CPU,
    fp32 value) against the JAX oracle on that level's queries."""
    shapes, value, x, y, w, _ = winbench.make_inputs(*HW, 4.0)
    value = value.astype(np.float32)
    cpk = msda.pack_coords_qmajor(*(torch.from_numpy(a) for a in (x, y, w)))
    plan = msda_tiles.encoder_tile_plan(shapes, torch.float32)
    # the oracle once on every query (queries are independent), sliced a level at a time
    every = np.asarray(jax.jit(msda_reference_qm, static_argnums=1)(jnp.asarray(value), shapes, x, y, w))
    for lq in range(len(shapes)):
        rows = msda._level_rows(shapes, lq)
        got = msda.msda_packed_level(torch.from_numpy(value), shapes, cpk, 4, plan, lq)
        want = every[:, rows]
        assert got.shape == (1, rows.stop - rows.start, 256)
        scale = np.abs(want).max()
        assert np.abs(got.numpy() - want).max() <= 1e-5 * scale


def test_tiles_override_reaches_the_plan(capsys):
    shapes = winbench.level_shapes(*HW)
    plan = msda_tiles.encoder_tile_plan(shapes, torch.bfloat16, tiles={0: (8, 8), 4: (1, 2)})
    assert plan.tiles[0] == (8, 8) and plan.tiles[4] == (1, 2) and plan.tiles[1:4] == msda_tiles.TILES[1:4]
    assert plan.windows[0] == tuple((msda_tiles.window_size(8, 16, Ht, 5), msda_tiles.window_size(8, 24, Wt, 5))
                                    for Ht, Wt in shapes)
    assert plan.n_tiles[0] == 2 * 3
    result = winbench.main(CPU + ["--lq", "0", "4", "--tiles", "0=8,8", "4=1,2", "--full"])
    capsys.readouterr()
    geo = result["records"]["geometry"]
    assert geo["geometry"][0]["tile"] == [8, 8] and geo["geometry"][4]["tile"] == [1, 2]
    assert geo["geometry"][0]["win"] == [list(wn) for wn in plan.windows[0]]
    assert geo["tiles_overridden"] == [0, 4] and result["records"]["lq0"]["tiles"] == 6
    assert result["summary"]["rows_equal_full"]
    # a tile whose fp32 accumulator alone exceeds a block's shared memory
    with pytest.raises(ValueError, match=r"query level 1: a \(64, 64\) tile's accumulator"):
        msda_tiles.encoder_tile_plan(shapes, torch.float32, tiles={1: (64, 64)})
    with pytest.raises(ValueError, match="query level 1"):
        winbench.main(CPU + ["--lq", "1", "--tiles", "1=64,64"])


def test_the_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        winbench.main(["--height", "64", "--width", "96"])
