"""The benchmark matrix and the on-card MSDA numerics gate: the counterpart
of the JAX package's root ``bench.py``.

``python -m codetr_torch.bench`` times the five configurations of
``MATRIX`` (or one, with ``--single``): each is built with seeded weights,
exported (``runtime.aot.compile_forward``), and its forward timed on the
card as a replayed CUDA graph between CUDA events, in blocks
(``make_loop_timer(graph=True)``), beside the same program's eager calls
(``graph=False``, what a Python caller pays).  It prints one JSON line per
configuration with the JAX script's keys (``metric``, ``value`` ms per
image, ``vs_baseline`` against ``TRT_BASELINE_MS``, p50 / p95 / min over
the blocks), the eager time and the card's name and power limit, and last
the headline line (the 1920x1280 configuration) with ``matrix``.

The JAX script's canary and sane-window hunt (``measure_canary``,
``hunt_sane_window``) are not ported: they worked around a time-shared
TPU, and a call here holds a dedicated card.

``verify_msda_on_card(height, width, dtype)`` builds the encoder's MSDA
inputs at a resolution (5 levels at strides 4..64, 8 heads, 4 points, head
dim 32; each tap at its query's anchor on the target level plus up to 3 px
of uniform jitter; weights normalised per head; numpy seed 0, the same
draws as the JAX gate) and holds the q-minor entry ``msda_grid_qm`` and the
packed entry ``msda_grid_packed`` against the plain ``msda_reference_qm``,
within the JAX gate's tolerances (``--verify``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from codetr_torch.config import co_dino_r50, co_dino_swin_l, tiny_test_config
from codetr_torch.models.codetr import build_codetr, check_device
from codetr_torch.ops import msda
from codetr_torch.ops.msda_grid import _anchor
from codetr_torch.runtime.aot import DTYPES, percentile_stats, compile_forward, make_loop_timer

# The reference's TensorRT FP16 latency of Swin-L Co-DINO, ms per image, on
# an RTX 4090 (BASELINE.md), by (width, height): the yardstick of
# ``vs_baseline``, another card than the one measured here.
TRT_BASELINE_MS = {(1920, 1280): 79.5, (1152, 768): 30.2, (608, 608): 13.4}

# The JAX bench.py's five configurations, field for field (fp16 on the
# reference maps to bf16); configs[4] pads a short batch by repeating its
# last image, so ms per image counts padded lanes as images.
MATRIX = [
    dict(family="r50", width=608, height=608, dtype_str="float32", batch_size=1,
         note="BASELINE configs[0]: R50 5-scale 608x608 fp32"),
    dict(family="r50", width=1152, height=768, dtype_str="bfloat16", batch_size=1,
         note="BASELINE configs[1]: R50 LSJ 1152x768 bf16"),
    dict(family="swin-l", width=608, height=608, dtype_str="bfloat16", batch_size=1,
         note="BASELINE configs[2]: Swin-L 608x608"),
    dict(family="swin-l", width=1920, height=1280, dtype_str="bfloat16", batch_size=1,
         note="BASELINE configs[3]: Swin-L 1920x1280, the exported program (the headline)"),
    dict(family="swin-l", width=1152, height=768, dtype_str="bfloat16", batch_size=4,
         note="BASELINE configs[4]: Swin-L batch 4, padded static shapes"),
]
FAMILIES = {"swin-l": co_dino_swin_l, "r50": co_dino_r50, "tiny": tiny_test_config}

STRIDES = (4, 8, 16, 32, 64)  # the 5-scale neck's levels
HEADS, POINTS, HEAD_DIM = 8, 4, 32
JITTER_PX = 3.0
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # max abs error


def verify_inputs(height: int, width: int, dtype=torch.float32, device="cuda"):
    """-> (value (1, K, 8, 32) in ``dtype``, spatial_shapes, x, y, w), the
    coordinates q-minor (1, 8, 5, 4, K) fp32, on ``device``."""
    device = check_device(device)
    shapes = tuple((-(-height // s), -(-width // s)) for s in STRIDES)
    K = sum(hh * ww for hh, ww in shapes)
    h, P, L, d = HEADS, POINTS, len(shapes), HEAD_DIM
    rng = np.random.default_rng(0)
    value = rng.standard_normal((1, K, h, d))
    x = np.zeros((1, h, L, P, K), np.float32)
    y = np.zeros_like(x)
    q0 = 0
    for Hq, Wq in shapes:
        iy, ix = np.meshgrid(np.arange(Hq), np.arange(Wq), indexing="ij")
        for lt, (Ht, Wt) in enumerate(shapes):
            ay = _anchor(iy, Hq, Ht).reshape(-1)
            ax = _anchor(ix, Wq, Wt).reshape(-1)
            y[0, :, lt, :, q0:q0 + Hq * Wq] = (ay + rng.uniform(-JITTER_PX, JITTER_PX, (h, P, Hq * Wq)) + 0.5) / Ht
            x[0, :, lt, :, q0:q0 + Hq * Wq] = (ax + rng.uniform(-JITTER_PX, JITTER_PX, (h, P, Hq * Wq)) + 0.5) / Wt
        q0 += Hq * Wq
    w = rng.uniform(0, 1, (1, h, L, P, K)).astype(np.float32)
    w /= w.sum(axis=(2, 3), keepdims=True)
    value = torch.from_numpy(value.astype(np.float32)).to(device, dtype)
    return (value, shapes, *(torch.from_numpy(a).to(device) for a in (x, y, w)))


def verify_msda_on_card(height: int, width: int, dtype=torch.float32, device="cuda") -> Dict[str, float]:
    """The gate at ``height`` x ``width``: raises on a mismatch, else returns
    the max abs errors of the q-minor and packed entries against the plain
    version and the mean |output|."""
    value, shapes, x, y, w = verify_inputs(height, width, dtype, device)
    want = msda.msda_reference_qm(value, shapes, x, y, w).float()
    got = msda.msda_grid_qm(value, shapes, x, y, w).float()
    got_packed = msda.msda_grid_packed(value, shapes, msda.pack_coords_qmajor(x, y, w), POINTS).float()
    errs = {
        "max_abs_err": (got - want).abs().max().item(),
        "max_abs_err_packed": (got_packed - want).abs().max().item(),
        "mean_abs_out": want.abs().double().mean().item(),
    }
    tol = TOLERANCE[dtype]
    for key in ("max_abs_err", "max_abs_err_packed"):
        if not errs[key] <= tol:
            raise AssertionError(f"MSDA gate at {height}x{width} {dtype}: {key} {errs[key]} (tol {tol})")
    return errs


def card_stamp(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; ``"cpu"`` on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[device.index or 0].strip()


def measure_config(*, family: str, width: int, height: int, dtype_str: str, batch_size: int,
                   iterations: int, msda_impl: str = "auto", note: Optional[str] = None,
                   blocks: int = 5, device="cuda", program=None) -> dict:
    """Build one configuration (seed-0 weights), export it and time its
    forward.  On the card: ``blocks`` blocks of ``iterations // blocks``
    replays of one CUDA graph, and as many eager calls of the same program;
    on the CPU (tests) only the eager calls, on the host clock.  ``program``
    (``(fn, example_args)``) skips the build and export.  Returns the JAX
    result's keys, ``eager_*`` beside them, the MSDA kernel launches of one
    call and ``device``, the card's name and power limit."""
    device = check_device(device)
    dtype = DTYPES[dtype_str]
    if program is None:
        model = build_codetr(FAMILIES[family](), dtype=dtype, device=device, seed=0, msda_impl=msda_impl)
        program = compile_forward(model, height=height, width=width, batch_size=batch_size, dtype=dtype)
        del model
    fn, example = program
    msda.launches = 0
    fn(*example)
    launches = msda.launches
    per_block = max(1, iterations // max(1, blocks))

    def timed(graph: bool):
        run = make_loop_timer(fn, example, graph=graph)
        run(per_block)
        return [run(per_block) / batch_size for _ in range(blocks)]

    on_card = device.type == "cuda"
    eager = percentile_stats(timed(False))
    stats = percentile_stats(timed(True)) if on_card else eager
    base = TRT_BASELINE_MS.get((width, height)) if family == "swin-l" else None
    value = stats["p50_ms"]
    result = {
        "metric": f"{family} {width}x{height} {dtype_str}" + (f" bs{batch_size}" if batch_size != 1 else "")
                  + (" device latency" if on_card else " CPU latency"),
        "value": value,
        "unit": "ms/image",
        "vs_baseline": base / value if base else None,
        "measurement_mode": ("p50 of CUDA-graph replays of the exported program, CUDA events" if on_card
                             else "p50 of eager calls on the CPU, perf_counter (no card)"),
        "p50_ms": stats["p50_ms"],
        "p95_ms": stats["p95_ms"],
        "min_ms": stats["min_ms"],
        "rounds": blocks,
        "iterations_per_round": per_block,
        "eager_ms": eager["p50_ms"],
        "eager_p95_ms": eager["p95_ms"],
        "eager_min_ms": eager["min_ms"],
        "msda_launches_per_call": launches,
        "device": card_stamp(device),
    }
    if note:
        result["note"] = note
    return result


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Time the exported Co-DINO forward on the card")
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1280)
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--iterations", type=int, default=10, help="timed iterations per configuration")
    ap.add_argument("--batch-size", type=int, default=1, help="the headline stays ms per image")
    ap.add_argument("--msda-impl", default="auto")
    ap.add_argument("--single", action="store_true",
                    help="time only the Swin-L configuration of --width/--height/--dtype/--batch-size")
    ap.add_argument("--verify", action="store_true",
                    help="first hold the MSDA kernels against the plain version at this size")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.verify:
        verify_msda_on_card(args.height, args.width, DTYPES[args.dtype], args.device)
    common = dict(iterations=args.iterations, msda_impl=args.msda_impl, device=args.device)
    if args.single:
        print(json.dumps(measure_config(family="swin-l", width=args.width, height=args.height,
                                        dtype_str=args.dtype, batch_size=args.batch_size, **common)))
        return
    matrix = []
    for spec in MATRIX:
        entry = measure_config(**spec, **common)
        print(json.dumps(entry), flush=True)
        matrix.append(entry)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    headline = dict(next(e for e, spec in zip(matrix, MATRIX) if spec["width"] == 1920))
    headline["matrix"] = matrix
    print(json.dumps(headline))


if __name__ == "__main__":
    main()
