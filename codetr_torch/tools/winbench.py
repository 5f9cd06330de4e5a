"""Per-query-level microbenchmark of K1, the encoder MSDA kernel: the port
of the JAX package's ``tools/winbench.py``.

    python -m codetr_torch.tools.winbench [--height 1920 --width 1280]
        [--lq 0 1 2] [--radius 5] [--jitter PX] [--tiles lq=th,tw ...]
        [--iters 5 --trials 6] [--full] [--module] [--verify]
        [--device cuda] [--dtype bfloat16]

It times one K1 call per query level at the encoder's shapes (h 8, P 4, L 5,
d 32, strides 4-64, a bf16 value by default) on init-like coordinates: each
query's grid anchor on every target level (``ops/msda_grid._anchor``) plus
uniform jitter of ``radius - 1`` px, weights normalised over (L, P), drawn
from ``default_rng(0)`` in the JAX tool's order, so the arrays are the JAX
tool's bit for bit.  A level's call is K1's level entry
(``ops/msda.py:msda_packed_level`` -> ``csrc/msda_fwd.cu:
msda_packed_fwd_levels``): the production kernel and plan, one block per
tile of that level.  ``--radius`` is the plan's halo, ``--tiles`` overrides
a level's query tile (``ops/msda_tiles.encoder_tile_plan(tiles=)``).

Output, one JSON object a line: first the geometry of the plan (per level
its tile, each target level's window, cells, whether it is staged, the
level's shared-memory bytes; the launch's ``smem_bytes``); per level, with
``--verify``, its rows against the plain version (``ops/msda.py:msda_plain``
on the fp32 value; fp32 within 1e-5 of the scale, bf16 2^-7 of each
element + 1e-5 of the scale: ``tools/attr.kernel_error``), then one record
a trial (``name``, ``ms``) and the level's record: ``best_sane_ms`` (the
fastest trial), ``median_ms``, ``spread``, its bytes bound (the level's
packed coordinates read, the value rows its taps' corners touch read once,
its output rows written, over ``PEAK_GBS``, the H100 SXM data sheet's
3.35 TB/s) and ``n_out``, its taps with a corner that no staged
window serves (the kernel reads it from global memory; the port's
counterpart of the JAX kernel's taps outside its envelope).  ``--full``
times the all-levels production call (``msda_grid_packed``; the same
kernel's all-levels entry with the overridden plan under ``--tiles`` or
another ``--radius``) and holds each level's rows against its rows bit for
bit (blocks are independent); ``--module`` times the port's
``MultiScaleDeformableAttention(grid_queries=True)`` at embed 256 (seed 0)
on the grid reference points, as the JAX tool times its flax module.  The
last line is the summary.

Each call is timed as ``tools/attr.py`` times a stage
(``runtime/aot.make_loop_timer``): on the card captured once in a CUDA
graph and replayed ``--iters`` times between CUDA events, ``--trials``
times; on the CPU (``--device cpu``, for the tests) eager calls of the
plain version on the host clock.  ``--device cuda`` (the default) raises
without a card.

n/a (ROADMAP §1): ``--dot-mode`` (the Pallas splat's MXU contraction; the
CUDA K1 has no matrix product), ``--debug-stage`` (``MSDA_WIN_DEBUG`` cut
stages out of the Pallas body), ``canary_ms`` (a chip call holds a
dedicated card) and the coarse fallback of levels whose tile holds under
16 queries (the port's K1 tiles every level, an override's too).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from codetr_torch.config import MSDAConfig
from codetr_torch.models.codetr import check_device, fp32_scope, init_module_weights
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.ops import msda, msda_tiles
from codetr_torch.ops.msda_grid import _anchor
from codetr_torch.runtime.aot import DTYPES, make_loop_timer
from codetr_torch.tools.attr import kernel_error
from codetr_torch.tools.trainbench import card

STRIDES = (4, 8, 16, 32, 64)
HEADS, POINTS, HEAD_DIM = 8, 4, 32
MODULE_EMBED = 256
WARMUP = 3  # calls before a timer's capture (make_loop_timer's default)
PEAK_GBS = 3350.0  # NVIDIA H100 SXM, HBM3 (data sheet)
NA = {
    "dot_mode": "n/a: the MXU contraction of the Pallas splat; the CUDA K1 has no matrix product",
    "debug_stage": "n/a: MSDA_WIN_DEBUG cut stages out of the Pallas body",
    "canary_ms": "n/a: a chip call holds a dedicated card",
    "coarse_fallback": "n/a: the port's K1 tiles every level, a --tiles override under 16 queries too",
}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=1920)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--lq", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--radius", type=int, default=5, help="the plan's window halo (the model's 5)")
    ap.add_argument("--jitter", type=float, default=None, help="px jitter around the grid anchor (default radius-1)")
    ap.add_argument("--tiles", nargs="*", default=[], help="per-lq tile overrides, e.g. 2=8,16")
    ap.add_argument("--iters", type=int, default=5, help="replays between two events, per trial")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--full", action="store_true", help="also time the all-levels production call")
    ap.add_argument("--module", action="store_true", help="also time the MSDA module (grid queries, embed 256)")
    ap.add_argument("--verify", action="store_true", help="hold each level's rows against the plain version")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES), help="the value's dtype")
    return ap.parse_args(argv)


def parse_tiles(specs) -> dict:
    """``["2=8,16", ...]`` -> ``{2: (8, 16), ...}``."""
    tiles = {}
    for spec in specs:
        lq, hw = spec.split("=")
        th, tw = (int(t) for t in hw.split(","))
        tiles[int(lq)] = (th, tw)
    return tiles


def level_shapes(height: int, width: int):
    return tuple((-(-height // s), -(-width // s)) for s in STRIDES)


def make_inputs(height: int, width: int, jitter: float):
    """The JAX tool's arrays (``tools/winbench.py:86-117``), drawn from
    ``default_rng(0)`` in its order: value (1, K, h, d) float64, q-minor x,
    y, w (1, h, L, P, K) float32; and the generator, for the module's
    query."""
    shapes = level_shapes(height, width)
    K, L = sum(hh * ww for hh, ww in shapes), len(shapes)
    rng = np.random.default_rng(0)
    value = rng.standard_normal((1, K, HEADS, HEAD_DIM))
    x = np.zeros((1, HEADS, L, POINTS, K), np.float32)
    y = np.zeros_like(x)
    q0 = 0
    for Hq, Wq in shapes:
        iy, ix = np.meshgrid(np.arange(Hq), np.arange(Wq), indexing="ij")
        for lt, (Ht, Wt) in enumerate(shapes):
            ay = _anchor(iy, Hq, Ht).reshape(-1)
            ax = _anchor(ix, Wq, Wt).reshape(-1)
            y[0, :, lt, :, q0:q0 + Hq * Wq] = (ay + rng.uniform(-jitter, jitter, (HEADS, POINTS, Hq * Wq)) + 0.5) / Ht
            x[0, :, lt, :, q0:q0 + Hq * Wq] = (ax + rng.uniform(-jitter, jitter, (HEADS, POINTS, Hq * Wq)) + 0.5) / Wt
        q0 += Hq * Wq
    w = rng.uniform(0, 1, (1, HEADS, L, POINTS, K)).astype(np.float32)
    w /= w.sum(axis=(2, 3), keepdims=True)
    return shapes, value, x, y, w, rng


def grid_refs(shapes) -> np.ndarray:
    """(1, K, L, 2) each query's pixel centre on its own level, for every
    level (the JAX tool's module references)."""
    K = sum(hh * ww for hh, ww in shapes)
    ref = np.zeros((1, K, len(shapes), 2), np.float32)
    q0 = 0
    for Hq, Wq in shapes:
        iy, ix = np.meshgrid(np.arange(Hq), np.arange(Wq), indexing="ij")
        ref[0, q0:q0 + Hq * Wq, :, 0] = ((ix + 0.5) / Wq).reshape(-1)[:, None]
        ref[0, q0:q0 + Hq * Wq, :, 1] = ((iy + 0.5) / Hq).reshape(-1)[:, None]
        q0 += Hq * Wq
    return ref


def geometry(plan: msda_tiles.TilePlan, lqs, args, jitter: float) -> dict:
    per_level = {}
    for lq in lqs:
        th, tw = plan.tiles[lq]
        wins = plan.windows[lq]
        per_level[lq] = {"tile": [th, tw], "win": [list(wn) for wn in wins],
                         "cells": [int(a * b) for a, b in wins], "staged": list(plan.staged[lq]),
                         "smem_bytes": plan.off_acc[lq] + th * tw * plan.head_dim * 4}
    return {"geometry": per_level, "radius": args.radius, "jitter": jitter, "shapes": [list(s) for s in plan.shapes],
            "dtype": args.dtype, "smem_bytes": plan.smem_bytes, "tiles_overridden": sorted(parse_tiles(args.tiles)),
            "n/a": NA}


def level_bytes(plan: msda_tiles.TilePlan, value: torch.Tensor, x, y, w, rows: slice) -> int:
    """The least bytes a level's call moves: its packed coordinates read,
    the value rows (key, head) its corner reads touch read once
    (``msda_tiles.corner_reads``), its output rows written."""
    bs, K, h, d = value.shape
    L, P = len(plan.shapes), x.shape[-1]
    dev = value.device
    widths = torch.tensor([ww for _, ww in plan.shapes], device=dev).view(1, 1, 1, L, 1)
    starts = torch.tensor(np.cumsum([0] + [hh * ww for hh, ww in plan.shapes[:-1]]), device=dev).view(1, 1, 1, L, 1)
    row = (torch.arange(bs, device=dev).view(bs, 1, 1, 1, 1) * K * h
           + torch.arange(h, device=dev).view(1, 1, h, 1, 1))
    touched = torch.zeros(bs * K * h, dtype=torch.bool, device=dev)
    for _, corners in msda_tiles.corner_reads(plan, x, y, w, queries=rows):
        for cx, cy, read, _ in corners:
            touched[((starts + cy * widths + cx) * h + row)[read]] = True
    n, elem = rows.stop - rows.start, value.element_size()
    return bs * n * 3 * h * L * P * 4 + int(touched.sum().item()) * d * elem + bs * n * h * d * elem


def time_calls(fn, args, iters: int, trials: int, on_card: bool, name: str, dtype: torch.dtype) -> dict:
    """``make_loop_timer``'s ms a call for each trial (one record a trial,
    the JAX keys) -> best, median, spread."""
    with torch.no_grad(), fp32_scope(dtype):
        run = make_loop_timer(fn, args, graph=on_card, warmup=WARMUP)
        per_trial = []
        for _ in range(trials):
            per_trial.append(run(iters))
            print(json.dumps({"name": name, "ms": per_trial[-1]}), flush=True)
    del run
    best = min(per_trial)
    return {"best_sane_ms": best, "median_ms": statistics.median(per_trial), "spread": max(per_trial) / best,
            "ms_per_trial": per_trial}


def main(argv=None) -> dict:
    """Run the benchmark; print its JSON lines, the summary last, and
    return ``{"records", "summary"}``."""
    args = parse_args(argv)
    device = check_device(args.device)
    dtype = DTYPES[args.dtype]
    on_card = device.type == "cuda"
    jitter = args.jitter if args.jitter is not None else args.radius - 1.0
    shapes, value_np, x_np, y_np, w_np, rng = make_inputs(args.height, args.width, jitter)
    K, L = value_np.shape[1], len(shapes)
    value = torch.from_numpy(value_np).to(device, dtype)
    x, y, w = (torch.from_numpy(a).to(device) for a in (x_np, y_np, w_np))
    cpk = msda.pack_coords_qmajor(x, y, w)
    xq, yq, wq = (a.permute(0, 4, 1, 2, 3) for a in (x, y, w))  # (1, K, h, L, P): the kernels' pixel maths
    tiles = parse_tiles(args.tiles)
    plan = msda_tiles.encoder_tile_plan(shapes, dtype, args.radius, head_dim=HEAD_DIM, points=POINTS,
                                        tiles=tiles)
    stamp = card(device)
    geo = geometry(plan, args.lq, args, jitter)
    print(json.dumps(geo), flush=True)

    records, level_out = {"geometry": geo}, {}
    for lq in args.lq:
        rows = msda._level_rows(shapes, lq)
        before = msda.launches
        with torch.no_grad():
            level_out[lq] = out = msda.msda_packed_level(value, shapes, cpk, POINTS, plan, lq)
        if args.verify:
            want = msda.msda_plain(value.float(), shapes, xq[:, rows], yq[:, rows], wq[:, rows])
            err = kernel_error(out, want)
            rec = {"lq": lq, "verify_max_err": err["max_abs_err"], **err,
                   "n_out": msda_tiles.taps_outside(plan, xq, yq, wq, queries=rows)}
            print(json.dumps(rec), flush=True)
            records[f"verify{lq}"] = rec
        timing = time_calls(lambda v, c, lq=lq: msda.msda_packed_level(v, shapes, c, POINTS, plan, lq),
                            (value, cpk), args.iters, args.trials, on_card, f"lq{lq}", dtype)
        served, reads = msda_tiles.staged_share(plan, xq, yq, wq, queries=rows)
        nbytes = level_bytes(plan, value, xq, yq, wq, rows)
        bound = nbytes / (PEAK_GBS * 1e9) * 1e3
        rec = {"lq": lq, **timing, "queries": rows.stop - rows.start, "tiles": plan.n_tiles[lq],
               "bytes": nbytes, "bound_ms": bound, "bound_by": "bytes",
               "x_over_bound": timing["best_sane_ms"] / bound,
               "n_out": msda_tiles.taps_outside(plan, xq, yq, wq, queries=rows),
               "corner_reads": reads, "corner_reads_staged": served,
               "launches": msda.launches - before if on_card else 0,
               "entry": "msda_packed_fwd_levels" if on_card else "plain version (CPU)"}
        print(json.dumps(rec), flush=True)
        records[f"lq{lq}"] = rec

    full = module = None
    if args.full:
        production = plan == msda_tiles.encoder_tile_plan(shapes, dtype, head_dim=HEAD_DIM, points=POINTS)
        if production or not on_card:
            def full_fn(v, c):
                return msda.msda_grid_packed(v, shapes, c, POINTS)
        else:  # the same entry with the overridden plan
            def full_fn(v, c):
                return msda._launch_packed(v, shapes, c, POINTS, msda.plan_ints(plan))
        with torch.no_grad():
            full_out = full_fn(value, cpk)
        equal = {lq: bool(torch.equal(out, full_out[:, msda._level_rows(shapes, lq)])) for lq, out in level_out.items()}
        full = time_calls(full_fn, (value, cpk), args.iters, args.trials, on_card, "full", dtype)
        rec = {"full_best_sane_ms": full["best_sane_ms"], **full, "rows_equal_full": equal,
               "call": "msda_grid_packed" if production else "msda_packed_fwd_levels with the overridden plan"}
        print(json.dumps(rec), flush=True)
        records["full"] = rec
    del level_out

    if args.module:
        cfg = MSDAConfig(embed_dims=MODULE_EMBED, num_heads=HEADS, num_levels=L, num_points=POINTS)
        mod = MultiScaleDeformableAttention(cfg, grid_queries=True)
        init_module_weights(mod, torch.Generator().manual_seed(0))
        mod = mod.to(device, dtype).eval()
        query = torch.from_numpy(rng.standard_normal((1, K, MODULE_EMBED)) * 0.02).to(device, dtype)
        ref = torch.from_numpy(grid_refs(shapes)).to(device)
        module = time_calls(lambda q, r: mod(q, q, None, None, r, shapes), (query, ref), args.iters, args.trials,
                            on_card, "module", dtype)
        rec = {"module_best_sane_ms": module["best_sane_ms"], **module}
        print(json.dumps(rec), flush=True)
        records["module"] = rec

    levels = {lq: records[f"lq{lq}"]["best_sane_ms"] for lq in args.lq}
    summary = {"H": args.height, "W": args.width, "K": K, "dtype": args.dtype, "device": str(device),
               "levels_best_sane_ms": levels, "sum_levels_ms": sum(levels.values()),
               "bound_ms": {lq: records[f"lq{lq}"]["bound_ms"] for lq in args.lq},
               "full_best_sane_ms": full and full["best_sane_ms"],
               "module_best_sane_ms": module and module["best_sane_ms"], "card": stamp}
    if args.verify:
        summary["verify_ok"] = all(records[f"verify{lq}"]["ok"] for lq in args.lq)
    if full is not None:
        summary["rows_equal_full"] = all(records["full"]["rows_equal_full"].values())
    print(json.dumps({"summary": summary}), flush=True)
    return {"records": records, "summary": summary}


def passed(summary: dict) -> bool:
    return summary.get("verify_ok", True) and summary.get("rows_equal_full", True)


if __name__ == "__main__":
    sys.exit(0 if passed(main()["summary"]) else 1)
