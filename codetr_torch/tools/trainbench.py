"""Train-step timing and the production MSDA VJP's gradcheck: the port of
the JAX package's ``tools/trainbench.py``.

    python -m codetr_torch.tools.trainbench [--height 608 --width 608]
        [--iters 3 --trials 6] [--gradcheck [--gradcheck-only]
        --gradcheck-hw 320] [--dtype bfloat16] [--config swin-l] [--device cuda]

``--gradcheck``: the encoder MSDA's production gradient (``msda_grid_packed``,
whose backward is the hand-written K2 kernel on the card) against autograd
through the plain MSDA (``msda_reference_qm``) on the JAX script's seeded
taps at ``--gradcheck-hw``, with its pass rule: output within 2e-4, value
and coordinate gradients within 1e-4 of their scale.

Then the JAX script's inputs (seed 0: pixels x 0.1, max_gt 32 boxes clipped
to [0.05, 0.3], labels in [0, 80), 7 valid) through the model built in
fp32 (the master weights), each timed over ``--trials`` runs of ``--iters``
calls between two CUDA events (on the CPU: the host clock):

  fwd        ``train_outputs`` + ``dino_detection_loss``, value only
  fwd+bwd    the same loss and its backward pass
  step       ``make_train_step(model, adamw(model), compute_dtype=dtype)``

all in ``--dtype`` compute, first as eager calls and then, on the card, as
captured programs: each stage captured once in a CUDA graph
(``runtime.aot.Replay``; the step by ``capture_train_step`` with
``adamw(model, capturable=True)``) and replayed, the counterparts of the
JAX script's ``jax.jit(loss_fn)``, ``jax.jit(jax.value_and_grad(loss_fn))``
and ``jax.jit(step)``.  The JSON lines carry the JAX keys ``fwd_ms``,
``fwdbwd_ms``, ``step_ms`` and ``bwd_over_fwd`` from the replays (the best
trial, as the JAX script reports; ``null`` on the CPU, where there is no
graph), the eager figures beside them (``fwd_eager_ms``, ...), each
stage's median and spread (slowest over fastest trial) in both modes, the
peak memory over the eager steps and over the captured step's warm-up and
capture, the captured step's graph pool, the Hungarian matching kernel's
time per step (its two launches on this step's costs), the port's kernels
in one traced eager fwd+bwd on the card (``kernels_fwdbwd``: launches and
device ms per kernel, ``utils.profiling.kernel_ms``; K2 is
``msda_tile_bwd_kernel``) and the card's name and power limit.  The
JAX script's canary is n/a: a chip call holds a dedicated card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from codetr_torch.config import CONFIGS
from codetr_torch.models.codetr import build_codetr, check_device
from codetr_torch.ops import hungarian, msda
from codetr_torch.ops.msda_grid import _anchor
from codetr_torch.parallel.losses import matching_problems
from codetr_torch.parallel.train import (WARMUP_STEPS, adamw, capture_train_step, make_train_step, run_in_dtype,
                                         train_loss)
from codetr_torch.runtime.aot import DTYPES, Replay, pool_bytes
from codetr_torch.utils.profiling import kernel_counts, kernel_ms, trace

TRAIN_CONFIGS = ("swin-l", "tiny")  # the JAX script's model; the CPU tests' one
STRIDES = (4, 8, 16, 32, 64)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=608)
    ap.add_argument("--iters", type=int, default=3, help="calls between two events, per trial")
    ap.add_argument("--trials", type=int, default=6)
    ap.add_argument("--gradcheck", action="store_true",
                    help="the production packed MSDA gradient against autograd of the plain MSDA first")
    ap.add_argument("--gradcheck-only", action="store_true", help="exit after the gradcheck")
    ap.add_argument("--gradcheck-hw", type=int, default=320,
                    help="square resolution of the gradcheck's encoder shapes")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES),
                    help="compute dtype; the weights stay float32")
    ap.add_argument("--config", default="swin-l", choices=TRAIN_CONFIGS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout.strip().splitlines()[device.index or 0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"{torch.cuda.get_device_name(device)} (nvidia-smi failed: {e})"


def gradcheck_inputs(hw: int, device: torch.device):
    """The JAX script's taps: per (query level, target level) anchors plus
    U(-3, 3) pixels, normalised weights, N(0, 1) value and upstream
    gradient; q-minor x, y, w (1, 8, 5, 4, K)."""
    shapes = tuple((-(-hw // s), -(-hw // s)) for s in STRIDES)
    K = sum(hh * ww for hh, ww in shapes)
    h, P, d, L = 8, 4, 32, len(shapes)
    rng = np.random.default_rng(0)
    x = np.zeros((1, h, L, P, K), np.float32)
    y = np.zeros_like(x)
    q0 = 0
    for Hq, Wq in shapes:
        iy, ix = np.meshgrid(np.arange(Hq), np.arange(Wq), indexing="ij")
        for lt, (Ht, Wt) in enumerate(shapes):
            ay = _anchor(iy, Hq, Ht).reshape(-1)
            ax = _anchor(ix, Wq, Wt).reshape(-1)
            y[0, :, lt, :, q0:q0 + Hq * Wq] = (ay + rng.uniform(-3, 3, (h, P, Hq * Wq)) + 0.5) / Ht
            x[0, :, lt, :, q0:q0 + Hq * Wq] = (ax + rng.uniform(-3, 3, (h, P, Hq * Wq)) + 0.5) / Wt
        q0 += Hq * Wq
    w = rng.uniform(0, 1, (1, h, L, P, K)).astype(np.float32)
    w /= w.sum(axis=(2, 3), keepdims=True)
    value = rng.standard_normal((1, K, h, d)).astype(np.float32)
    g = rng.standard_normal((1, K, h * d)).astype(np.float32)
    return shapes, P, *(torch.from_numpy(a).to(device) for a in (x, y, w, value, g))


def gradcheck(hw: int, device: torch.device) -> dict:
    """The production packed MSDA and its gradient against autograd through
    the plain version, the JAX script's pass rule."""
    shapes, P, x, y, w, value, g = gradcheck_inputs(hw, device)
    h, L = value.shape[2], len(shapes)
    cpk = msda.pack_coords_qmajor(x, y, w)

    def vjp(fn):
        v, c = value.clone().requires_grad_(), cpk.clone().requires_grad_()
        out = fn(v, c)
        gv, gc = torch.autograd.grad(out, (v, c), g)
        return out.detach(), gv, gc

    out_p, gv_p, gc_p = vjp(lambda v, c: msda.msda_grid_packed(v, shapes, c, P))
    out_o, gv_o, gc_o = vjp(lambda v, c: msda.msda_reference_qm(
        v, shapes, *msda.unpack_coords_qmajor(c, h, L, P)))
    err_out = (out_p - out_o).abs().max().item()
    ev = (gv_p - gv_o).abs().max().item() / (gv_o.abs().max().item() + 1e-9)
    ec = (gc_p - gc_o).abs().max().item() / (gc_o.abs().max().item() + 1e-9)
    return {"resolution": [hw, hw], "spatial_shapes": [list(s) for s in shapes],
            "out_max_err": err_out, "grad_value_rel": ev, "grad_coords_rel": ec,
            "pass": bool(err_out < 2e-4 and ev < 1e-4 and ec < 1e-4)}


def train_inputs(height: int, width: int, cfg, device: torch.device):
    """The JAX script's inputs, drawn in its order from seed 0; max_gt 32
    with 7 valid, for every config (the tiny one has 12 queries: the
    matching solves its 7 valid rows)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal((1, height, width, 3)) * 0.1).astype(np.float32))
    max_gt = 32
    num_classes = cfg.head.num_classes
    boxes = np.clip(rng.uniform(0.1, 0.9, (1, max_gt, 4)), 0.05, 0.3).astype(np.float32)
    labels = rng.integers(0, num_classes, (1, max_gt))
    valid = np.arange(max_gt)[None] < 7
    return tuple(t.to(device) for t in (
        x, torch.zeros(1, height, width), torch.from_numpy(boxes), torch.from_numpy(labels),
        torch.from_numpy(valid)))


def make_timer(device: torch.device, iters: int, trials: int):
    """Times ``fn`` after one warm-up call: ms per call of each trial, over
    ``iters`` calls between two CUDA events (the host clock on the CPU)."""

    def timer(fn):
        fn()
        per_trial = []
        for _ in range(trials):
            if device.type == "cuda":
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                end.synchronize()
                per_trial.append(start.elapsed_time(end) / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                per_trial.append((time.perf_counter() - t0) * 1e3 / iters)
        return per_trial

    return timer


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = check_device(args.device)
    stamp = card(device)
    result = {"device": str(device), "card": stamp}
    if args.gradcheck:
        result["gradcheck"] = gradcheck(args.gradcheck_hw, device)
        print(json.dumps({"gradcheck": result["gradcheck"], "card": stamp}), flush=True)
        if args.gradcheck_only:
            return result

    dtype = DTYPES[args.dtype]
    cfg = CONFIGS[args.config]()
    model = build_codetr(cfg, device=device, seed=0)  # fp32 master weights
    batch = train_inputs(args.height, args.width, cfg, device)
    timer = make_timer(device, args.iters, args.trials)

    def fwd(*b):
        with torch.no_grad():
            return (train_loss(model, b, compute_dtype=dtype),)

    def fwd_bwd(*b):
        model.zero_grad(set_to_none=True)
        return (train_loss(model, b, compute_dtype=dtype, backward=True),)

    def reset_peak():
        if device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None

    eager = {"fwd": timer(lambda: fwd(*batch)), "fwd+bwd": timer(lambda: fwd_bwd(*batch))}
    kernels = None
    if device.type == "cuda":  # one eager fwd+bwd traced: each kernel's launches and device time
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp):
                fwd_bwd(*batch)
                torch.cuda.synchronize()
            counts, ms = kernel_counts(tmp), kernel_ms(tmp)
        kernels = {n: {"launches": counts[n], "ms": ms[n]} for n in counts}
    step = make_train_step(model, adamw(model), compute_dtype=dtype)
    reset_peak()
    eager["step"] = timer(lambda: step(*batch))
    peak = peak_gib()
    del step
    replay, captured_peak, pool = {}, None, None
    if device.type == "cuda":
        for name, fn in (("fwd", fwd), ("fwd+bwd", fwd_bwd)):
            program = Replay(fn, batch, warmup=WARMUP_STEPS)
            replay[name] = timer(lambda: program(*batch))
            del program
        torch.cuda.empty_cache()
        reset_peak()
        step = capture_train_step(model, adamw(model, capturable=True), batch, compute_dtype=dtype)
        captured_peak = peak_gib()
        pool = pool_bytes(step.replay.graph) / 2**30
        # no empty_cache() while the graph lives (runtime/aot.py's note)
        replay["step"] = timer(lambda: step(*batch))
        del step
        torch.cuda.empty_cache()
    for mode, times in (("eager", eager), ("replay", replay)):
        for name, ms in times.items():
            print(json.dumps({"stage": name, "mode": mode, "ms_per_trial": ms, "best_ms": min(ms),
                              "median_ms": statistics.median(ms)}), flush=True)

    # the matching: this step's two launches on its own costs
    with torch.no_grad():
        outputs = run_in_dtype(model, dtype, lambda m, x, mk: m.train_outputs(x, mk), *batch[:2])
        problems = matching_problems(outputs, *batch[2:])
    before = hungarian.launches
    match_ms = timer(lambda: [hungarian.linear_assignment(*p) for p in problems])
    per_step = (hungarian.launches - before) // (1 + args.trials * args.iters) if device.type == "cuda" else 0

    def keys(times, suffix):
        if not times:
            return {f"{k}{suffix}_ms": None for k in ("fwd", "fwdbwd", "step")} | {
                f"bwd_over_fwd{suffix}": None, f"median{suffix}_ms": None, f"spread{suffix}": None}
        f, fb = min(times["fwd"]), min(times["fwd+bwd"])
        return {f"fwd{suffix}_ms": f, f"fwdbwd{suffix}_ms": fb, f"step{suffix}_ms": min(times["step"]),
                f"bwd_over_fwd{suffix}": round((fb - f) / f, 2),
                f"median{suffix}_ms": {k: statistics.median(v) for k, v in times.items()},
                f"spread{suffix}": {k: max(v) / min(v) for k, v in times.items()}}

    result.update({
        "H": args.height, "W": args.width, "config": args.config, "dtype": args.dtype,
        **keys(replay, ""), **keys(eager, "_eager"),
        "peak_gib": peak, "peak_captured_gib": captured_peak, "pool_captured_gib": pool,
        "matching_ms_per_step": min(match_ms),
        "matching_launches_per_step": per_step,
        "matching_shapes": [list(p[0].shape) for p in problems],
        "kernels_fwdbwd": kernels,
    })
    print(json.dumps({k: v for k, v in result.items() if k != "gradcheck"}), flush=True)
    return result


if __name__ == "__main__":
    main()
