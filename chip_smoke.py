#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every part of it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a result):
1. identify the card (nvidia-smi name and power limit, torch/CUDA versions);
2. build the CUDA kernels from ``codetr_torch/csrc``, one nvcc each, all at
   once (build seconds and ``-Xptxas -v`` printed), and print the encoder
   kernels' tile plans (``ops/msda_tiles.py``: tiles, windows, staged
   pairs, shared memory per block) with the tiled kernels' registers;
3. hold the MSDA forward and backward kernels against their plain PyTorch
   versions at the 768x1152 main-path shapes (encoder: 5 levels, K = 73,656
   queries, packed and q-minor layouts, the latter also through
   ``multi_scale_deformable_attention(grid_queries=True)``; decoder: 900
   queries with 4-coordinate references), and the forward's packed and
   reference entries at R50's 608x608 shapes too (K = 30,785) and at
   768x1152 with batch 4 (eval_coco's batch: value (4, 73,656, 8, 32)),
   value in fp32 and in bf16; then the tiled grid-query entries (the packed forward
   and backward, K1 and K2, and the q-minor forward, K3) on taps placed
   against their shared-memory windows (edges, one pixel out, halo + 1,
   grid lines, far), batch 2, at both sizes; then the Hungarian matching
   kernel (``csrc/hungarian.cu``) against its plain version (the same
   assignment, ties included) and scipy (the valid rows' cost) at the
   losses' shapes (max_gt 32 with 7 valid over 900, 30,785 and 73,656
   queries; 100 of 100 valid) and on a mask with holes, no valid row,
   integer costs and duplicated columns, and with more padded rows than
   columns (max_gt 32 over 12 queries with 7, 15 and 32 valid; 100 over 90
   with 95: the valid rows alone, or the transposed problem against scipy's
   assignment), each launch timed beside scipy;
4. check the full-width Swin-L model's inference forward on the card
   against the same model run on the CPU through the plain versions, at a
   small input;
5. the serving path: 3 synthetic images of different sizes through the
   Swin-L ``Inferencer`` at 768x1152 in fp32 and one in bf16, checking the
   outputs and that each forward launched the forward kernel 12 times (6
   encoder + 6 decoder layers), with the postprocess (score gate,
   per-class (soft-)NMS, rescale; the ``Inferencer`` captures it in a CUDA
   graph, ``runtime.aot.Replay``) timed on the model's outputs captured and
   eager at batch 1 and 4 and as one eager call per image; on the fp32
   path the captured postprocess is held against the eager one on the card
   bit for bit and against the CPU (keep masks and labels equal, scores
   and boxes 1e-6) for nms, soft_nms and soft_nms_gaussian at batch 1 and
   4, and one ``Inferencer`` call over 9 images at batch 4 against three
   separate calls (each batch's own detections); then the on-card MSDA gate
   (``codetr_torch.bench.verify_msda_on_card``, the JAX ``bench.py
   --verify``) at 1280x1920 in fp32 and bf16, which launches the q-minor
   kernel; then the R50 family: its full-width model on the card against
   the CPU at a small input, and the ``Inferencer`` at 608x608 fp32 and at
   768x1152 bf16 (3 images each, 12 forward launches per image); then the
   shift-window MSDA kernel (K4) against its plain version at the 768x1152
   and 608x608 encoder shapes (radius 5 and 4, and a window limit that
   sends every cross-level pair through the coarse-pair escape), and on its
   own tile-adversarial taps (window cells 0 and W - 1, one cell and more
   outside, the edges of the tile's window, far; batch 2), the
   corrected ``msda_grid_qm(impl="grid_pallas" | "grid")`` against the
   exact function with its launch counts and its gradient, the Swin-L
   encoder stage with ``msda_impl="grid_pallas"`` against ``"auto"`` (one
   K4 launch per layer, one K3 correction per layer with taps outside the
   envelope, no K1; the ``"auto"`` run counts the share of the model's own
   corner reads that the tiled kernel serves from shared memory, at least
   0.7), and the gather microbenchmarks (K5) against their plain versions
   at the sweep's and at tail sizes, their library's ``I2F`` count (none in
   a loop), then their sweep (each call beside its launch floor and, for the
   gathers, the shared-memory wavefront figure; the launches per C entry
   checked) and gather_lane under 1- to 8-way bank conflicts;
6. one full-width Swin-L train step on the card against the CPU at a small
   input (loss and every gradient, each leaf held against its own measured
   sensitivity); then the training path: Swin-L train steps at 768x1152,
   batch 1, synthetic boxes, and with ``SwinConfig.with_cp`` at batch 1 and
   at a batch that does not fit the card without it, checking that each
   step launched the forward and the backward kernel 12 times each and that
   the loss stays finite, and that each step launched the matching kernel
   twice; then the same step at batch 1, without and with ``with_cp``,
   captured in one CUDA graph (``parallel.train.capture_train_step``, AdamW
   with ``capturable=True``) beside an eager twin of the same seed and
   optimizer: 3 replays against 3 eager steps (the losses and every
   parameter, gradient and AdamW state tensor), the replays' times between
   CUDA events, one traced replay's kernels by name (K1 and K2 once per
   encoder layer, the decoder's entries once per decoder layer, the
   matching twice: the host counters count only at capture) and the peak
   memory with the graph's pool; then ``dino_detection_loss`` at the Swin-L 608x608 shapes (batch
   2) under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   synchronisation; 2 matching launches), one bf16-compute step over fp32
   weights on the card against the CPU's at a small input (each device's
   costs solved by both solvers, which must agree; the encoder stage's
   matches equal or a rounding tie; the decoder's compared as encoder
   tokens beside the two devices' top-k agreement; the loss within 2e-2;
   parameters fp32 and moved), and
   ``codetr_torch.tools.trainbench --gradcheck`` (the JAX
   ``tools/trainbench.py``: the production MSDA gradient against autograd
   of the plain one at 320x320, then Swin-L 608x608 bf16 fwd, fwd+bwd and
   step times, each stage replayed as one captured CUDA graph (the JAX
   keys) and as eager calls, peak memory, the matching's time a step);
7. time the kernels, their plain versions (the tiled entries also beside
   the direct-gather design on the same taps, with those taps' staged
   share; K3 beside packing its coordinates for K1 and running K1), the
   end-to-end latency and the train step, one step's matching on its own
   costs (608x608 batch 2, 768x1152 batch 1) beside its plain version and
   scipy, and print them beside the card's name and power limit;
8. the deployment path (``codetr_torch.runtime.aot``): the JAX ``bench.py``
   matrix's configs[0] (R50 608x608 fp32) and [3] (Swin-L 1280x1920 bf16)
   exported, saved and reloaded in a temporary directory, each reloaded
   program held against the in-process model on a served image (scores
   2e-4, boxes 0.1 px; 12 forward-kernel launches a forward; the fp32 one
   with TF32 off at every convolution); the five configurations of
   ``codetr_torch.bench.MATRIX`` timed as CUDA-graph replays beside eager
   calls of the same program (configs[0] and [3]: the reloaded ones), one
   JSON line each; the Swin-L 768x1152 bf16 batch-4 ``Inferencer`` through
   the reloaded fused program (uint8 in, preprocessing inside) on 5 images
   against the host-preprocess eager one; one traced Swin-L 768x1152 fp32
   image (``utils.profiling.trace``): the share of the window in which a
   kernel ran, the captured postprocess's kernels and their device time,
   and the five kernels with the most time; then COCO
   evaluation (``codetr_torch.eval_coco``) with the seed-0 Swin-L weights
   as a ``.pth`` whose ``meta`` holds numpy values: on ten synthetic
   ``.npy`` images (the last batch of 4 short), fp32 detections held, for
   the first batch, against the raw outputs postprocessed on the CPU and
   rescaled on the host in float64 as the JAX script does, then made the
   ground truth and scored again at fp32 (determinism and the evaluator's
   plumbing: mAP = AR_100 = 1); then the JAX script's defaults (bf16,
   soft-NMS, batch 4; 12 forward-kernel launches a batch) twice over 100
   images (25 full batches) against ground truth at COCO val2017's density,
   with images per second, seconds per part and peak memory;
9. checkpoint day (``codetr_torch.tools.rehearsal`` at the JAX
   ``tools/rehearsal.py``'s defaults, Swin-L 608x608, 2 images): a seed-0
   fp32 writer on the host with trained-like sampling offsets written as a
   ``.pth`` (numpy values in its meta), read by a bf16 reader on the card
   and scored against the writer (12 forward-kernel launches a forward;
   ``pass``, box IoU p50 >= 0.9, reported beside the fp32 writer's own
   scores on bf16-rounded inputs and weights), the staged share of its
   encoder taps per layer beside seed 0's and its exported forward's
   replay times; an fp32 reader of the same file against the writer on the
   ladder (scores 2e-4, boxes 0.1 px set-wise; where a near-tied proposal
   changed rank between the devices, ``compare_models``' 1e-3 and 0.5 px);
   K1 against its plain version on
   the first encoder layer's taps of seed 0's model and of offset drift 1.0
   and 2.0, timed, with their staged shares;
10. stage attribution (``codetr_torch.tools.attr``, the JAX ``tools/attr.py``,
   ``swinattr.py``, ``encattr.py`` and ``membench.py``) at 1280x1920 bf16
   on one seed-0 Swin-L model: the ``model`` suite (features, detect, full)
   and the ``encoder`` suite (its eleven parts) with ``--verify`` (K1's
   encoder and decoder entries against the plain version on the modules'
   own inputs) and a traced replay each, the ``swin`` suite over stages
   0-3 and the ``mem`` suite; each stage's ms beside its floor at the GEMM
   and copy ceilings measured in the same run (fails on a kernel check, a
   stage with no time, ``features + detect`` more than 15% off ``full``, a
   trace without its kernels); then the ``kernels`` line and, last, the
   result line.

The script leaves PyTorch's TF32 flags at their defaults (printed at the
start), as a user's process has them: the port's fp32 forward and train
step pin full fp32 themselves, so the fp32 comparisons, latencies and step
times are full-fp32 figures.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from codetr_torch import Inferencer, build_codetr, co_dino_r50, co_dino_swin_l
from codetr_torch.bench import FAMILIES, MATRIX, measure_config, verify_inputs, verify_msda_on_card
from codetr_torch.models.codetr import full_fp32
from codetr_torch.ops import _build
from codetr_torch.ops import hungarian, msda, msda_grid, msda_tiles
from codetr_torch.parallel import losses as losses_module
from codetr_torch.parallel.losses import dino_detection_loss, matching_problems
from codetr_torch.parallel.train import adamw, capture_train_step, make_train_step, run_in_dtype, train_loss
from codetr_torch.tools import attr, rehearsal, trainbench
from codetr_torch.tools.attr import union_us
from codetr_torch.ops.nms import postprocess_detections
from codetr_torch.runtime.aot import (DTYPES, Replay, compile_forward, load_executable, msda_nodes, pool_bytes,
                                     save_executable)
from codetr_torch.utils.preprocess import preprocess
from codetr_torch.utils.profiling import kernel_counts, trace
from torch.utils._python_dispatch import TorchDispatchMode

HEIGHT, WIDTH = 768, 1152  # the serving size
VERIFY_HW = (1280, 1920)  # the on-card MSDA gate's size, the JAX bench.py's default
R50_SERVING = ((608, 608, torch.float32), (768, 1152, torch.bfloat16))  # BASELINE configs[0], [1]
CHECK_HW = (384, 384)  # small input for the card-vs-CPU model check
TRAIN_CHECK_HW = (256, 256)  # small input for the card-vs-CPU train-step check (K = 5,456)
PERTURBATIONS = 3  # seeded 1e-7 weight perturbations that measure each gradient's spread
CP_BATCH = 6  # a train batch whose step does not fit the card without SwinConfig.with_cp
EXPORTED = (0, 3)  # the matrix configurations exported, saved and reloaded (R50 fp32, Swin-L 1280x1920)
MATRIX_ITERATIONS = 20  # per configuration and mode: 5 blocks of 4
KERNELS = ("msda_fwd", "msda_bwd", "msda_shift_fwd", "gatherbench", "hungarian")
NMS_TYPES = ("nms", "soft_nms", "soft_nms_gaussian")
POST_BATCHES = (1, 4)  # the postprocess's batch sizes: latency, and eval_coco's and the matrix's batch 4
TRAINBENCH_HW = (608, 608)  # the JAX tools/trainbench.py's size: the sync-free loss's shapes
# a captured step's fp32 gradient against the eager step's from the same
# state: the largest |difference| over every leaf, relative to the largest
# |gradient|.  Not zero: the MSDA backward kernels and PyTorch's
# scatter-adds (the bias tables' index backward) sum with float atomics in
# no fixed order, and a second eager backward differs as much (printed);
# leaves that are zero in exact arithmetic are pure rounding noise, so no
# per-leaf bound holds for them
CAPTURE_GRAD_TOL = 1e-5
SEED = 0
DEVICE = "cuda"
CONFIG = co_dino_swin_l
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, fp32
# FLOP/s outside the tensor cores (the kernel's FMAs run on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# a full-width model on the card against the CPU (``compare_models``): the
# decoder starts from the top-900 encoder proposals, and a near-tied one can
# differ between the devices, which moves every query a little through the
# decoder's self-attention; scores, boxes px
MODEL_SCORE_TOL, MODEL_BOX_TOL = 1e-3, 0.5


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def fmt_ms(times) -> str:
    return "/".join(f"{t:.1f}" for t in times)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def level_shapes(h: int, w: int):
    """Neck level sizes for an h x w input: strides 4..32, then the extra
    stride-2 conv (ceil division, as the convolutions give)."""
    shapes = []
    for s in (4, 8, 16, 32):
        shapes.append((-(-h // s), -(-w // s)))
    hh, ww = shapes[-1]
    shapes.append(((hh - 1) // 2 + 1, (ww - 1) // 2 + 1))
    return tuple(shapes)


def msda_inputs(shapes, num_queries, heads=8, dim=32, points=4, decoder=False, batch=1):
    """Seeded inputs on the card: value (B, K, h, d) fp32; locations (B, Q,
    h, L, P, 2) and weights (B, Q, h, L, P) fp32.  Taps mix offsets of a
    few pixels around each query, far-out taps (beyond the level) and
    exact-integer pixel taps."""
    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(SEED)
    K = sum(h * w for h, w in shapes)
    Q, L, B = num_queries, len(shapes), batch
    value = torch.randn(B, K, heads, dim, generator=g, device=dev)
    if decoder:
        ctr = torch.rand(B, Q, 1, 1, 1, 2, generator=g, device=dev) * 0.8 + 0.1
        wh = torch.rand(B, Q, 1, 1, 1, 2, generator=g, device=dev) * 0.3 + 0.02
        off = torch.randn(B, Q, heads, L, points, 2, generator=g, device=dev) * 2.0
        loc = ctr + off / points * wh * 0.5
    else:
        refs = torch.cat([
            torch.stack(torch.meshgrid(
                (torch.arange(w, device=dev) + 0.5) / w, (torch.arange(h, device=dev) + 0.5) / h,
                indexing="xy"), -1).reshape(-1, 2)
            for h, w in shapes
        ])  # (K, 2) xy
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
        off = torch.randn(B, Q, heads, L, points, 2, generator=g, device=dev) * 4.0
        loc = refs[None, :, None, None, None, :] + off / size[None, None, None, :, None, :]
    far = torch.rand(loc.shape[:-1], generator=g, device=dev) < 0.05
    loc = torch.where(far[..., None], torch.rand(loc.shape, generator=g, device=dev) * 4 - 1.5, loc)
    exact = torch.rand(loc.shape[:-1], generator=g, device=dev) < 0.1
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)[:, None, :]
    snapped = (torch.round(loc * size - 0.5) + 0.5) / size
    loc = torch.where(exact[..., None], snapped, loc).contiguous()
    w = torch.randn(B, Q, heads, L * points, generator=g, device=dev).softmax(-1)
    return value, loc, w.reshape(B, Q, heads, L, points).contiguous()


def pack(loc, w):
    bs, Q = w.shape[:2]
    return torch.cat(
        [loc[..., 0].reshape(bs, Q, -1), loc[..., 1].reshape(bs, Q, -1), w.reshape(bs, Q, -1)], -1
    ).contiguous()


def touched_rows(value, shapes, loc, w) -> int:
    """Distinct (key, head) value rows that the taps of nonzero weight read."""
    bs, K, h, d = value.shape
    L = loc.shape[3]
    dev = value.device
    wl = torch.tensor([ww for _, ww in shapes], device=dev).view(1, 1, 1, L, 1)
    hl = torch.tensor([hh for hh, _ in shapes], device=dev).view(1, 1, 1, L, 1)
    starts = torch.tensor(np.cumsum([0] + [hh * ww for hh, ww in shapes[:-1]]), device=dev)
    px = torch.floor(loc[..., 0] * wl - 0.5).long()
    py = torch.floor(loc[..., 1] * hl - 0.5).long()
    head = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    rows = []
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        x, y = px + dx, py + dy
        ok = (x >= 0) & (x < wl) & (y >= 0) & (y < hl) & (w != 0)
        k = starts.view(1, 1, 1, L, 1) + y.clamp(0) * wl + x.clamp(0)
        rows.append(((k * h + head))[ok])
    return torch.unique(torch.cat(rows)).numel()


def roofline(nbytes, flops):
    """The larger of bytes over HBM rate and operations over the fp32 rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def bound_ms(value, shapes, loc, w, out_dtype):
    """Least time for the forward: bytes (each value row the taps really
    touch, the coordinates and weights, the output; each once) and the FMAs."""
    bs, K, h, d = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    nbytes = (
        touched_rows(value, shapes, loc, w) * d * value.element_size()
        + loc.numel() * 4 + w.numel() * 4
        + bs * Q * h * d * torch.empty((), dtype=out_dtype).element_size()
    )
    return roofline(nbytes, bs * Q * h * L * P * 4 * d * 2)


def bwd_bound_ms(value, shapes, loc, w):
    """Least time for the backward: bytes (each value row the taps touch and
    the upstream gradient, read once; the coordinates and weights read and
    their gradients written; the whole value gradient, zeros included,
    written once in the value's dtype) and 12 fp32 operations per tap and
    channel: the four dot products g . v_corner as FMAs (the weight and both
    coordinate gradients combine them once per tap) and the four scatter
    products a * hat * g.  The scatter's adds are atomics that run in L2,
    not on the fp32 pipes, so they are not charged to its peak."""
    bs, K, h, d = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    e = value.element_size()
    nbytes = (
        touched_rows(value, shapes, loc, w) * d * e
        + bs * Q * h * d * e
        + 2 * (loc.numel() + w.numel()) * 4
        + value.numel() * e
    )
    return roofline(nbytes, bs * Q * h * L * P * d * (4 * 2 + 4))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(name, value, kernel_fn, plain_fn, stamp):
    """Kernel vs plain on the same inputs, fp32 and bf16 values; returns the
    fp32 max abs error and the per-call numbers."""
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        v = value.to(dtype)
        got = kernel_fn(v)
        torch.cuda.synchronize()
        want = plain_fn(v.float())  # same values, fp32 result
        if got.dtype != dtype or got.shape != want.shape:
            fail(f"{name}: kernel gave {got.dtype} {tuple(got.shape)}")
        if not torch.isfinite(got).all():
            fail(f"{name}: non-finite kernel output")
        diff = (got.float() - want).abs()
        scale = max(want.abs().max().item(), 1.0)
        if dtype == torch.float32:
            rel = diff.max().item() / scale
            ok, tol_text = rel < 1e-5, "1e-5 of scale"
        else:
            # bf16 output, fp32 accumulation: only the final rounding (half a
            # bf16 ulp, at most 2^-8 relative) separates it from the fp32
            # result; allow one ulp for sums that straddle a rounding step
            rel = (diff / (want.abs() * 2.0**-7 + 1e-5 * scale)).max().item()
            ok, tol_text = rel <= 1.0, "<= 1 (2^-7 of each element + 1e-5 of scale)"
        key = "fp32" if dtype == torch.float32 else "bf16"
        res[f"max_abs_err_{key}"] = diff.max().item()
        res[f"rel_{key}"] = rel
        print(f"{name} {key}: max abs err {diff.max().item():.3e}, relative {rel:.3e} "
              f"(tolerance {tol_text}) [{stamp}]")
        if not ok:
            fail(f"{name} {key}: kernel disagrees with the plain version")
    return res


def check_backward(name, value, grad_out, kernel_fn, plain_fn, stamp):
    """Backward kernel vs plain backward on the same values, fp32 and bf16
    value (and upstream gradient).  Coordinate and weight gradients, and
    the fp32 value gradient, within 1e-5 of their scale; a bf16 value
    gradient within its own bf16 rounding.  Returns the max abs errors."""
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        v, g = value.to(dtype), grad_out.to(dtype)
        got = kernel_fn(v, g)
        torch.cuda.synchronize()
        want = plain_fn(v.float(), g.float())
        key = "fp32" if dtype == torch.float32 else "bf16"
        errs = []
        for part, a, b in zip(("grad_value", "grad_x", "grad_y", "grad_w"), got, want):
            if a.shape != b.shape or not torch.isfinite(a).all():
                fail(f"{name} {key} {part}: {tuple(a.shape)} (want {tuple(b.shape)}) or non-finite")
            diff = (a.float() - b).abs()
            if part == "grad_value" and dtype == torch.bfloat16:
                if a.dtype != torch.bfloat16:
                    fail(f"{name} bf16: grad_value came back as {a.dtype}")
                scale = max(b.abs().max().item(), 1.0)
                rel = (diff / (b.abs() * 2.0**-7 + 1e-5 * scale)).max().item()
                ok, tol_text = rel <= 1.0, "<= 1 (2^-7 of each element + 1e-5 of scale)"
            else:
                rel = diff.max().item() / b.abs().max().item()
                ok, tol_text = rel < 1e-5, "1e-5 of scale"
            errs.append(diff.max().item())
            print(f"{name} {key} {part}: max abs err {diff.max().item():.3e}, relative "
                  f"{rel:.3e} (tolerance {tol_text}) [{stamp}]")
            if not ok:
                fail(f"{name} {key} {part}: backward kernel disagrees with the plain backward")
        res[f"max_abs_err_{key}"] = max(errs)
    return res


def forward_checks(hw, stamp, points=4, batch=1):
    """The forward kernel's packed (encoder, Q = K) and reference-layout
    (decoder, Q = 900) entries against their plain versions at an input
    size's level shapes and a batch size -> ((encoder errors, decoder
    errors), (shapes, value, loc_e, w_e, cpk, loc_d, w_d))."""
    shapes = level_shapes(*hw)
    K = sum(h * w for h, w in shapes)
    size = f"{hw[0]}x{hw[1]}" + (f" batch {batch}" if batch > 1 else "")
    print(f"levels at {size}: {shapes}, K = {K}")
    value, loc_e, w_e = msda_inputs(shapes, K, batch=batch)
    cpk = pack(loc_e, w_e)
    _, loc_d, w_d = msda_inputs(shapes, 900, decoder=True, batch=batch)
    enc = check_kernel(
        f"encoder MSDA {size} (packed, Q={K})", value,
        lambda v: msda.msda_grid_packed(v, shapes, cpk, points),
        lambda v: msda.msda_grid_packed_plain(v, shapes, cpk, points), stamp,
    )
    dec = check_kernel(
        f"decoder MSDA {size} (reference layout, Q=900)", value,
        lambda v: msda.multi_scale_deformable_attention(v, shapes, loc_d, w_d),
        lambda v: msda.multi_scale_deformable_attention_plain(v, shapes, loc_d, w_d), stamp,
    )
    return (enc, dec), (shapes, value, loc_e, w_e, cpk, loc_d, w_d)


def print_plans(builds, stamp):
    """The encoder kernels' tile plans at each serving size (tiles, windows,
    staged pairs, shared memory per block) and the tiled kernels' registers
    and spills from ``-Xptxas -v``."""
    for hw in ((HEIGHT, WIDTH), R50_SERVING[0][:2]):
        shapes = level_shapes(*hw)
        for dtype in (torch.float32, torch.bfloat16):
            for backward in (False, True):
                plan = msda_tiles.encoder_tile_plan(shapes, dtype, backward=backward)
                staged = sum(map(sum, plan.staged))
                print(f"tile plan {hw[0]}x{hw[1]} {'bwd' if backward else 'fwd'} "
                      f"{str(dtype).split('.')[-1]}: tiles {plan.tiles}, blocks per head "
                      f"{plan.n_tiles}, windows per (lq, lt) {plan.windows}, {staged} of "
                      f"{len(shapes) ** 2} pairs staged {plan.staged}, shared memory "
                      f"{plan.smem_bytes} bytes per block [{stamp}]")
    plan = msda_tiles.encoder_tile_plan(level_shapes(*VERIFY_HW), torch.float32)
    print(f"tile plan {VERIFY_HW[0]}x{VERIFY_HW[1]} (the gate, K3) fwd float32: windows per (lq, lt) "
          f"{plan.windows}, {sum(map(sum, plan.staged))} of 25 pairs staged {plan.staged}, shared memory "
          f"{plan.smem_bytes} bytes per block [{stamp}]")
    for hw in ((HEIGHT, WIDTH), R50_SERVING[0][:2]):
        for radius, max_window in SHIFT_CASES:
            for dtype in (torch.float32, torch.bfloat16):
                plan = msda_grid.shift_tile_plan(level_shapes(*hw), dtype, radius, max_window)
                print(f"K4 tile plan {hw[0]}x{hw[1]} radius {radius} max_window {max_window} "
                      f"{str(dtype).split('.')[-1]}: windows per (lq, lt) {plan.windows}, "
                      f"{sum(map(sum, plan.staged))} of 25 pairs staged {plan.staged}, shared memory "
                      f"{plan.smem_bytes} bytes per block [{stamp}]")
    for built in builds:
        lines = built.log.splitlines()
        for i, line in enumerate(lines):
            if "msda_tile_" in line and "Compiling entry" in line:
                print(f"{built.path.name}: {line.strip()} -> "
                      + " / ".join(m.strip() for m in lines[i + 2:i + 4]))


def adversarial_taps(shapes, batch=2, heads=8, dim=32, points=4):
    """Tile-adversarial taps of the encoder kernels, batch ``batch``: on each
    axis, at random, corner 00 on its window's first or last pixel, one
    pixel before the window or corner 10 one past it, halo + 1 pixels from
    the query's reference point, or a grid line near it; 10% of the taps
    far (anywhere within half a level of it).  Each location is nudged by an
    ulp where needed so that the kernels' rounded ``loc * size - 0.5`` lands
    exactly on the intended integer pixel.  Returns value (batch, K, h, d)
    fp32, locations (batch, K, h, L, P, 2), weights (batch, K, h, L, P)."""
    plan = msda_tiles.encoder_tile_plan(shapes, torch.float32)
    wy0, wx0, wh, ww, _ = msda_tiles.query_windows(plan, DEVICE)  # (K, L)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    K, L = wy0.shape
    shape = (batch, K, heads, L, points)
    refs = torch.cat([
        torch.stack(torch.meshgrid(
            (torch.arange(w, device=DEVICE) + 0.5) / w, (torch.arange(h, device=DEVICE) + 0.5) / h,
            indexing="xy"), -1).reshape(-1, 2)
        for h, w in shapes
    ])  # (K, 2) xy

    def axis(start, size, ref, n):
        n = torch.tensor(n, dtype=torch.float32, device=DEVICE).view(1, 1, 1, L, 1)
        s, z = (a.float().view(1, K, 1, L, 1) for a in (start, size))
        r = ref.view(1, K, 1, 1, 1) * n - 0.5  # the reference's pixel on each level
        u = torch.rand(shape, generator=g, device=DEVICE) * 0.98 + 0.01
        sign = torch.where(torch.rand(shape, generator=g, device=DEVICE) < 0.5, -1.0, 1.0)
        choices = torch.stack(torch.broadcast_tensors(
            s, s + z - 1, s - 1 + u, s + z - 1 + u,
            r + sign * (msda_tiles.HALO + 1), torch.round(r + sign * u * 3)))
        kind = torch.randint(0, len(choices), shape, generator=g, device=DEVICE)
        px = choices.gather(0, kind[None])[0]
        far = torch.rand(shape, generator=g, device=DEVICE) < 0.1
        px = torch.where(far, (torch.rand(shape, generator=g, device=DEVICE) * 2 - 0.5) * n, px)
        loc = (px + 0.5) / n
        for _ in range(2):  # land loc * n - 0.5 on px where fp32 allows
            back = loc * n - 0.5
            loc = torch.where(back < px, torch.nextafter(loc, loc + 1),
                              torch.where(back > px, torch.nextafter(loc, loc - 1), loc))
        return loc

    wl = [w for _, w in shapes]
    hl = [h for h, _ in shapes]
    loc = torch.stack([axis(wx0, ww, refs[:, 0], wl), axis(wy0, wh, refs[:, 1], hl)], -1)
    w = torch.randn(batch, K, heads, L * points, generator=g, device=DEVICE).softmax(-1)
    value = torch.randn(batch, K, heads, dim, generator=g, device=DEVICE)
    return value, loc.contiguous(), w.reshape(shape).contiguous()


def adversarial_checks(stamp):
    """The tiled encoder kernels (packed forward and backward) against their
    plain versions on ``adversarial_taps`` at both serving sizes, batch 2,
    with the tolerances of ``check_kernel`` / ``check_backward``."""
    res = {}
    for hw in ((HEIGHT, WIDTH), R50_SERVING[0][:2]):
        shapes = level_shapes(*hw)
        value, loc, w = adversarial_taps(shapes)
        cpk, P, L = pack(loc, w), w.shape[4], len(shapes)
        size = f"{hw[0]}x{hw[1]}"
        share = msda_tiles.staged_share(msda_tiles.encoder_tile_plan(shapes, torch.float32),
                                        loc[..., 0], loc[..., 1], w)
        print(f"tile-adversarial taps {size}, batch 2: {share[0]} of {share[1]} corner reads in a "
              f"staged window ({share[0] / share[1]:.4f})")
        fwd = check_kernel(
            f"encoder MSDA {size} tile-adversarial (packed, batch 2)", value,
            lambda v: msda.msda_grid_packed(v, shapes, cpk, P),
            lambda v: msda.msda_grid_packed_plain(v, shapes, cpk, P), stamp,
        )
        qm = to_qm(loc, w)
        fwd_qm = check_kernel(
            f"encoder MSDA {size} tile-adversarial (q-minor, K3, batch 2)", value,
            lambda v: msda.msda_grid_qm(v, shapes, *qm),
            lambda v: msda.msda_reference_qm(v, shapes, *qm), stamp,
        )
        g = torch.randn(value.shape[0], value.shape[1], 256,
                        generator=torch.Generator(device=DEVICE).manual_seed(SEED + 10), device=DEVICE)
        bwd = check_backward(
            f"encoder MSDA backward {size} tile-adversarial (packed, batch 2)", value, g,
            lambda v, gg: split_packed(*msda._launch_packed_bwd(v, shapes, cpk, P, gg), 8, L, P),
            lambda v, gg: plain_backward(v, shapes, loc, w, gg), stamp,
        )
        res[size] = {"fwd": fwd, "fwd_qm": fwd_qm, "bwd": bwd, "staged_share": share[0] / share[1]}
        del value, loc, w, cpk, g, qm
    torch.cuda.empty_cache()
    return res


def upstream_grads(num_keys):
    """Seeded upstream gradients (1, Q, 256) of the encoder (Q = K) and
    decoder (Q = 900) calls."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    return (torch.randn(1, num_keys, 256, generator=gen, device=DEVICE),
            torch.randn(1, 900, 256, generator=gen, device=DEVICE))


def plain_backward(value, shapes, loc, w, grad_out):
    return msda.msda_backward_plain(value, shapes, loc[..., 0], loc[..., 1], w, grad_out)


def to_qm(loc, w):
    """Reference layout -> contiguous q-minor x, y, w, each (bs, h, L, P, Q)."""
    return tuple(a.permute(0, 2, 3, 4, 1).contiguous() for a in (loc[..., 0], loc[..., 1], w))


def from_qm(x, y, w):
    """q-minor x, y, w -> reference-layout views (loc, w)."""
    return torch.stack([x, y], -1).permute(0, 4, 1, 2, 3, 5), w.permute(0, 4, 1, 2, 3)


def plain_backward_qm(value, shapes, x, y, w, grad_out):
    """The plain backward, its coordinate gradients moved to q-minor."""
    grads = msda.msda_backward_plain(value, shapes, *(a.permute(0, 4, 1, 2, 3) for a in (x, y, w)),
                                     grad_out)
    return (grads[0], *(a.permute(0, 2, 3, 4, 1) for a in grads[1:]))


def split_packed(grad_value, gcpk, heads, levels, points):
    """(grad_value, packed coordinate gradient) -> the four gradients."""
    return (grad_value, *msda._unpack(gcpk, heads, levels, points))


def synthetic_targets(rng, max_gt, n_valid, num_classes, device, batch=1):
    """Padded boxes as tools/trainbench.py makes them: cxcywh in [0.1, 0.3]."""
    boxes = np.clip(rng.uniform(0.1, 0.9, (batch, max_gt, 4)), 0.05, 0.3).astype(np.float32)
    labels = rng.integers(0, num_classes, (batch, max_gt))
    valid = np.repeat(np.arange(max_gt)[None] < n_valid, batch, 0)
    return (torch.from_numpy(boxes).to(device), torch.from_numpy(labels).to(device),
            torch.from_numpy(valid).to(device))


def key_bias_mask(name, shape):
    """Entries of a gradient that are zero in exact arithmetic (float32
    rounding noise on both devices): the key thirds of the Swin window
    attention's qkv bias and of the decoder self-attention's in-proj bias
    (a softmax over keys ignores q.b)."""
    mask = torch.zeros(shape, dtype=torch.bool)
    if name.endswith("w_msa.qkv.bias") or name.endswith("attentions.0.attn.in_proj_bias"):
        c = shape[-1] // 3
        mask[..., c:2 * c] = True
    return mask


def leaf_errors(grads, ref):
    """Each leaf's error of ``grads`` against ``ref``, relative to the
    leaf's own scale in ``ref``, the key-bias entries left out."""
    errs = {}
    for n, r in ref.items():
        m = key_bias_mask(n, r.shape)
        errs[n] = ((grads[n][~m] - r[~m]).abs().max() / r[~m].abs().max()).item()
    return errs


def compare_train_steps(cfg, shape_hw, stamp):
    """One train step of the Swin-L model on the card (kernel path) against
    the same weights on the CPU (plain path), fp32, at a small padded input.

    Tolerances: the loss within 1e-4 relative.  Each parameter's gradient
    within max(1e-4, 3 x its spread) of its scale, where the spread is how
    far the card's own gradient of that leaf moves when every weight is
    moved by 1e-7 relative: the median over ``PERTURBATIONS`` seeded
    perturbations, since one now and then flips a discrete choice (the
    Hungarian matching), which moves whole leaves by ~1e-1.  The gradient
    is ill-conditioned at a random init (bilinear sampling's derivative
    jumps at grid lines): the regression branches and the query embedding
    move by up to ~1e-2 of their scale, most other leaves by ~1e-4.  The
    key-bias entries, zero in exact arithmetic, must stay below 1e-5 of the
    largest gradient on both devices."""
    h, w = shape_hw
    rng = np.random.default_rng(SEED + 2)
    img = torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32))
    mask = torch.zeros(1, h, w)
    mask[:, int(h * 0.75):, :] = 1.0
    mask[:, :, int(w * 0.875):] = 1.0
    targets = synthetic_targets(rng, 8, 3, cfg.head.num_classes, "cpu")
    cpu = build_codetr(cfg, device="cpu", seed=SEED)
    gpu = copy.deepcopy(cpu).to(DEVICE)
    with torch.no_grad():  # the proposals each device picks
        aux = [m.query_head.run_transformer(m.features(x), mk)[2]
               for m, x, mk in ((cpu, img, mask), (gpu, img.to(DEVICE), mask.to(DEVICE)))]
    picked = [a["topk_idx"][0].cpu() for a in aux]
    scores = [a["enc_class"].float().max(-1)[0][0].cpu()[i] for a, i in zip(aux, picked)]
    k = len(picked[0])
    differ = k - len(set(picked[0].tolist()) & set(picked[1].tolist()))
    score_gap = (scores[0].sort()[0] - scores[1].sort()[0]).abs().max().item()
    tied = torch.unique(scores[0], return_counts=True)[1].max().item()
    del aux

    per = launches_per_forward(cfg)
    dev_args = (img.to(DEVICE), mask.to(DEVICE), *(t.to(DEVICE) for t in targets))

    def card_step(model):
        """One train step on the card; its loss and gradients (on the host)."""
        before_f, before_b = msda.launches, msda.launches_bwd
        loss = make_train_step(model, adamw(model))(*dev_args).item()
        torch.cuda.synchronize()
        if (msda.launches - before_f, msda.launches_bwd - before_b) != (per, per):
            fail(f"train check launched the kernels {msda.launches - before_f} / "
                 f"{msda.launches_bwd - before_b} times, not {per} / {per}")
        return loss, grads_of(model)

    def grads_of(model):
        grads = {}
        for n, p in model.named_parameters():
            if p.grad is None:
                fail(f"{n} got no gradient")
            grads[n] = p.grad.cpu()
        return grads

    # the card's steps first, while the CPU model still holds the start weights
    loss_g, grads_g = card_step(gpu)
    del gpu
    moved_errs, moved_losses = {n: [] for n in grads_g}, []
    for i in range(PERTURBATIONS):
        moved = copy.deepcopy(cpu).to(DEVICE)
        gen = torch.Generator().manual_seed(SEED + 5 + i)
        with torch.no_grad():
            for p in moved.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen).to(DEVICE))
        loss_m, grads_m = card_step(moved)
        moved_losses.append(loss_m)
        for n, e in leaf_errors(grads_m, grads_g).items():
            moved_errs[n].append(e)
        del moved, grads_m
    torch.cuda.empty_cache()
    spread = {n: statistics.median(e) for n, e in moved_errs.items()}

    t0 = time.perf_counter()
    loss_c = make_train_step(cpu, adamw(cpu))(img, mask, *targets).item()
    cpu_s = time.perf_counter() - t0
    grads_c = grads_of(cpu)

    top = max(g.abs().max().item() for g in grads_c.values())
    noise = max(g[key_bias_mask(n, g.shape)].abs().amax().item()
                for grads in (grads_c, grads_g) for n, g in grads.items()
                if key_bias_mask(n, g.shape).any())
    gap = leaf_errors(grads_g, grads_c)
    tol = {n: max(1e-4, 3 * spread[n]) for n in gap}
    failed = [n for n in gap if gap[n] > tol[n]]
    worst = max(gap, key=lambda n: gap[n] / tol[n])
    widened = sorted((n for n in gap if tol[n] > 1e-4), key=lambda n: -gap[n])
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print(f"Swin-L train step {h}x{w} card vs CPU: loss {loss_g:.6f} vs {loss_c:.6f} "
          f"(rel err {loss_err:.3e}, tol 1e-4); gradients per leaf, of its scale, tol "
          f"max(1e-4, 3 x median spread over {PERTURBATIONS} perturbations of 1e-7, losses "
          f"{moved_losses}): worst against "
          f"its tol {worst} {gap[worst]:.3e} (spread {spread[worst]:.3e}, tol {tol[worst]:.3e}); "
          f"largest gap {max(gap.values()):.3e}, largest spread {max(spread.values()):.3e}; "
          f"{sum(g > 1e-4 for g in gap.values())}/{len(gap)} leaves over 1e-4 and "
          f"{sum(g > 1e-3 for g in gap.values())} over 1e-3; {len(widened)} leaves with a tol "
          f"above 1e-4; {len(failed)} over their tol; key-bias gradients (zero in exact "
          f"arithmetic) {noise:.3e}, tol {1e-5 * top:.3e}; {differ}/{k} top-k proposals differ "
          f"by index, sorted top-k scores within {score_gap:.3e} (largest group of equal scores "
          f"{tied}); CPU step {cpu_s:.1f} s [{stamp}]")
    for n in widened[:12]:
        print(f"  widened: {n} gap {gap[n]:.3e}, spread {spread[n]:.3e}")
    for n in failed:
        print(f"  over its tol: {n} gap {gap[n]:.3e}, spread {spread[n]:.3e}")
    if loss_err > 1e-4 or failed or noise > 1e-5 * top:
        fail("the train step on the card disagrees with the CPU reference")


def train_batch(cfg, batch):
    """The training path's inputs at 768x1152: ``batch`` images of N(0, 0.1)
    pixels with no padding, tools/trainbench.py's synthetic targets
    (max_gt 32, 7 valid)."""
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(
        (rng.standard_normal((batch, HEIGHT, WIDTH, 3)) * 0.1).astype(np.float32)).to(DEVICE)
    mask = torch.zeros(batch, HEIGHT, WIDTH, device=DEVICE)
    return x, mask, synthetic_targets(rng, 32, 7, cfg.head.num_classes, DEVICE, batch)


def run_training(cfg, batch, timed=3, split=False):
    """The training path at full size: Swin-L at 768x1152, fp32.  Times 1
    warm-up + ``timed`` steps, and with ``split`` the predictions, the loss
    forward and forward+backward first (1 warm-up + 3 timed each); every
    timed step must launch the forward and the backward kernel once per
    MSDA layer and give a finite loss.  Reads the bytes allocated on entry
    (what earlier phases left) and just before the timed steps' peak."""
    held_at_start = torch.cuda.memory_allocated()
    x, mask, targets = train_batch(cfg, batch)
    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    opt = adamw(model)
    step = make_train_step(model, opt)

    def loss():
        return dino_detection_loss(model.train_outputs(x, mask), *targets)[0]

    def fwd():
        with torch.no_grad():
            return loss()

    def predict():
        with torch.no_grad():
            return model.train_outputs(x, mask)

    def fwd_bwd():  # in full fp32, as the step runs it
        model.zero_grad(set_to_none=True)
        with full_fp32():
            loss().backward()

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    res = {"held_at_start": held_at_start}
    if split:
        res.update(predict_ms=host_ms(predict), fwd_ms=host_ms(fwd), fwd_bwd_ms=host_ms(fwd_bwd))
        with host_matching():  # the former design, beside it
            res["fwd_host_matching_ms"] = host_ms(fwd)
        res["problems"] = matching_problems(predict(), *targets)  # one step's costs
    step(x, mask, *targets)  # warm-up step: the optimizer's state
    torch.cuda.synchronize()
    res["held"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per = launches_per_forward(cfg)
    msda.launches = msda.launches_bwd = hungarian.launches = 0
    step_ms, losses, per_step = [], [], []
    for _ in range(timed):
        f0, b0, h0 = msda.launches, msda.launches_bwd, hungarian.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(x, mask, *targets).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append((msda.launches - f0, msda.launches_bwd - b0, hungarian.launches - h0))
    launches = {"msda_fwd": msda.launches, "msda_bwd": msda.launches_bwd, "hungarian": hungarian.launches}
    peak = torch.cuda.max_memory_allocated()
    if any(p != (per, per, 2) for p in per_step):
        fail(f"train steps launched (MSDA forward, backward, matching) kernels {per_step}, "
             f"not ({per}, {per}, 2) each")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss {losses}")
    print(f"training path fp32 {HEIGHT}x{WIDTH} batch {batch}, with_cp "
          f"{cfg.swin.with_cp}: {timed} steps, kernel launches (MSDA forward, backward, "
          f"matching) per step {per_step}, "
          f"losses {losses}")
    del model, opt, step
    torch.cuda.empty_cache()
    # the peak of the bytes callers asked for, before the allocator rounds
    # them to its blocks (a rounding that depends on what earlier phases
    # left in its cache)
    requested = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    res.update(step_ms=step_ms, losses=losses, peak_bytes=peak, requested_peak=requested,
               launches=launches)
    return res


def held_text(r) -> str:
    return (f"of which {r['held'] / 2**30:.3f} GiB held before the timed steps "
            f"({r['held_at_start'] / 2**30:.3f} GiB left by earlier phases), requested "
            f"peak {r['requested_peak'] / 2**30:.3f} GiB")


def fwd_bwd_peak(cfg, batch):
    """Peak bytes of one forward+backward of the training loss at ``batch``
    (no optimizer state), or None where the card ran out of memory."""
    x, mask, targets = train_batch(cfg, batch)
    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        with full_fp32():  # as the step runs it
            dino_detection_loss(model.train_outputs(x, mask), *targets)[0].backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
        peak = None
    del model, x, mask, targets
    gc.collect()
    torch.cuda.empty_cache()
    return peak


def train_state(model, opt):
    """name -> tensor: every parameter, its gradient and its AdamW state."""
    names = {p: n for n, p in model.named_parameters()}
    out = {}
    for n, p in model.named_parameters():
        out[n], out[f"{n}.grad"] = p.detach(), p.grad
    for p, st in opt.state.items():
        out.update({f"{names[p]}.{k}": v for k, v in st.items()})
    return out


def captured_training(cfg, batch, stamp, steps=3, timed=5):
    """The train step captured in one CUDA graph (``capture_train_step``,
    fp32, AdamW with ``capturable=True``) beside an eager twin of the same
    seed and optimizer, ``steps`` steps each.  Each step: the losses equal
    bit for bit; the replay's gradient within ``CAPTURE_GRAD_TOL`` of each
    leaf's scale of the eager step's (float atomics sum in no fixed order in
    the MSDA backward kernels and PyTorch's scatter-adds; a second eager
    backward from the same state gives the eager step's own spread, printed
    beside it); the twin's AdamW then steps on the replay's gradient and
    must land on the replay's parameters and moments bit for bit, so both
    start the next step from one state.  Then ``timed`` replays between CUDA
    events, one traced replay (each MSDA kernel once per layer, the matching
    twice, counted by kernel name: the host counters count only at capture)
    and the peak memory with the graph's pool."""
    x, mask, targets = train_batch(cfg, batch)
    args = (x, mask, *targets)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    twin = copy.deepcopy(model).cpu()  # on the card after the capture's memory is read
    opt = adamw(model, capturable=True)
    counters = (msda.launches, msda.launches_bwd, hungarian.launches)
    t0 = time.perf_counter()
    step = capture_train_step(model, opt, args)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    at_capture = tuple(c - c0 for c, c0 in zip((msda.launches, msda.launches_bwd, hungarian.launches), counters))
    peak = torch.cuda.max_memory_allocated()  # the warm-up's eager steps and the capture
    # the graph's private pool, and every live tensor; no empty_cache() while
    # the graph lives (runtime/aot.py's note)
    pool, held = pool_bytes(step.replay.graph), torch.cuda.memory_allocated()
    twin = twin.to(DEVICE)
    twin_opt = adamw(twin, capturable=True)

    def eager_grads():
        twin.zero_grad(set_to_none=True)
        loss = train_loss(twin, args, backward=True)
        return loss, {n: p.grad for n, p in twin.named_parameters()}

    def gap(got, want):
        """(the largest gap over every leaf, of the largest gradient; the leaf
        with the largest gap of its own scale, and that gap)"""
        scale = max(w.abs().max().item() for w in want.values())
        own = {n: ((got[n] - w).abs().max() / w.abs().max().clamp_min(1e-30)).item() for n, w in want.items()}
        worst = max(own, key=own.get)
        return max((got[n] - w).abs().max().item() for n, w in want.items()) / scale, worst, own[worst]

    losses, eager_losses, grad_gaps, eager_spread, unequal = [], [], [], [], []
    for _ in range(steps):
        loss = step(*args)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        eager_loss, want = eager_grads()
        eager_spread.append(gap(eager_grads()[1], want))
        losses.append(loss.item())
        eager_losses.append(eager_loss.item())
        if not torch.equal(loss, eager_loss):
            fail(f"a captured step's loss {loss.item()!r} differs from the eager twin's {eager_loss.item()!r}")
        grad_gaps.append(gap(grads, want))
        for n, p in twin.named_parameters():
            p.grad = grads[n]
        twin_opt.step()
        after, twin_after = train_state(model, opt), train_state(twin, twin_opt)
        unequal.append(sum(not torch.equal(after[n], t) for n, t in twin_after.items() if not n.endswith(".grad")))
    del twin, twin_opt, grads, want, after, twin_after
    gc.collect()
    step_ms = []
    for _ in range(timed):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(*args)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            step(*args)
            torch.cuda.synchronize()
        counts = kernel_counts(tmp)
    tc = cfg.head.transformer
    want_counts = {"msda_tile_fwd_kernel": tc.num_encoder_layers, "msda_fwd_kernel": tc.num_decoder_layers,
                   "msda_tile_bwd_kernel": tc.num_encoder_layers, "msda_bwd_kernel": tc.num_decoder_layers,
                   "hungarian_kernel": 2}
    label = f"train fp32 {HEIGHT}x{WIDTH} batch {batch}, with_cp {cfg.swin.with_cp}, captured"
    print(f"{label}: capture {capture_s:.1f} s (warm-up included; host counters at capture: MSDA forward, "
          f"backward, matching {at_capture}); {steps} replays against {steps} eager steps of a twin: losses "
          f"{losses} vs {eager_losses} (bit for bit); each step's largest gradient gap of the largest "
          f"gradient " + ", ".join(f"{g:.3e}" for g, _, _ in grad_gaps) + f" (tol {CAPTURE_GRAD_TOL:.0e}; a "
          f"second eager backward's: " + ", ".join(f"{g:.3e}" for g, _, _ in eager_spread) + "), the largest "
          f"of a leaf's own scale " + ", ".join(f"{g:.3e} ({n})" for _, n, g in grad_gaps) + " (the second eager "
          f"backward's: " + ", ".join(f"{g:.3e} ({n})" for _, n, g in eager_spread) + "); parameter and AdamW "
          f"tensors unequal after the twin's AdamW on the replay's gradient {unequal}; replays "
          f"{fmt_ms(step_ms)} ms (CUDA events); one replay's kernels {counts}; peak {peak / 2**30:.3f} GiB "
          f"allocated over the warm-up and the capture; the graph's pool {pool / 2**30:.3f} GiB, "
          f"{held / 2**30:.3f} GiB allocated after the capture (the weights, AdamW's moments, the static "
          f"batch, the gradients in the pool) [{stamp}]")
    del step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    if {k: counts[k] for k in want_counts} != want_counts:
        fail(f"a captured step's replay launched {counts}, not {want_counts}")
    if max(g for g, _, _ in grad_gaps) > CAPTURE_GRAD_TOL or any(unequal):
        fail("the captured train step disagrees with the eager twin")
    if not all(np.isfinite(losses)):
        fail(f"non-finite captured training loss {losses}")
    return {"step_ms": step_ms, "losses": losses, "counts": counts, "at_capture": at_capture,
            "peak_bytes": peak, "pool": pool, "held": held, "capture_s": capture_s, "grad_gaps": grad_gaps,
            "eager_spread": eager_spread}


def assignment_cases(rng):
    """(name, cost (P, R, C) float32, row_valid (P, R)) for the matching
    kernel: the losses' shapes (max_gt 32 with 7 valid over the decoder's
    900 queries, 6 layers x 2 images, and over the encoder's 30,785 and
    73,656, 2 images; 100 of 100 valid, COCO's most boxes in an image) and
    the hard cases: a mask with holes, no valid row, integer costs and
    duplicated columns (many optimal assignments); then more padded rows
    than columns (max_gt 32 over the tiny config's 12 queries, 6 layers x 2
    images), with 7 valid (V <= C: the valid rows alone) and with 15 and 32
    valid (V > C: the transposed problem), and max_gt 100 over 90 with 95
    valid, in the losses' form."""
    def make(P, R, C, n_valid=None, kind="normal", holes=False):
        if kind == "integer":
            cost = rng.integers(0, 5, (P, R, C)).astype(np.float32)
        else:
            cost = (rng.standard_normal((P, R, C)) * 3).astype(np.float32)
        if kind == "duplicated":
            cost[..., 1::2] = cost[..., 0::2][..., :C // 2]
        valid = np.arange(R)[None].repeat(P, 0) < (R if n_valid is None else n_valid)
        if holes:
            valid &= rng.random((P, R)) < 0.6
        return torch.from_numpy(cost).to(DEVICE), torch.from_numpy(valid).to(DEVICE)

    return [
        ("decoder 12x32x900, 7 valid", *make(12, 32, 900, 7)),
        ("encoder 608x608 2x32x30785, 7 valid", *make(2, 32, 30785, 7)),
        ("encoder 768x1152 2x32x73656, 7 valid", *make(2, 32, 73656, 7)),
        ("COCO max 2x100x900, 100 valid", *make(2, 100, 900)),
        ("holes 4x32x900", *make(4, 32, 900, holes=True)),
        ("no valid row 3x32x900", *make(3, 32, 900, 0)),
        ("integer costs 4x32x900, 20 valid", *make(4, 32, 900, 20, "integer")),
        ("duplicated columns 4x32x900, 20 valid", *make(4, 32, 900, 20, "duplicated")),
        ("more rows than columns 12x32x12, 7 valid", *make(12, 32, 12, 7)),
        ("more rows than columns 12x32x12, 15 valid", *make(12, 32, 12, 15)),
        ("more rows than columns 12x32x12, 32 valid", *make(12, 32, 12)),
        ("more rows than columns 4x100x90, 95 valid", *make(4, 100, 90, 95)),
    ]


def scipy_assignment(cost, valid):
    """``scipy.optimize.linear_sum_assignment`` on each problem's valid rows,
    from a host copy of the costs: the port's former matching.  A problem
    with more valid rows than columns is solved transposed, its padding rows
    at ``hungarian.INVALID_COST`` (optax's answer, which the kernel gives),
    and its answer is put in ``linear_assignment``'s form (each row's
    column, 0 for a row no column takes).  Returns the valid rows' total
    costs (float64; NaN for the transposed problems), the transposed
    problems' answers by problem index, and the wall ms, copy included."""
    from scipy.optimize import linear_sum_assignment

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host, rows = cost.cpu().numpy(), valid.cpu().numpy()
    totals, transposed = [], {}
    for p, (c, v) in enumerate(zip(host, rows)):
        if v.sum() > c.shape[1]:
            q, g = linear_sum_assignment(np.where(v[:, None], c, np.float32(hungarian.INVALID_COST)).T)
            transposed[p] = np.zeros(len(v), np.int64)
            transposed[p][g] = q
            totals.append(np.nan)
            continue
        sub = c[np.nonzero(v)[0]]
        r, k = linear_sum_assignment(sub)
        totals.append(float(sub[r, k].sum(dtype=np.float64)))
    return np.array(totals), transposed, (time.perf_counter() - t0) * 1e3


def valid_totals(cost, valid, cols) -> np.ndarray:
    """Each problem's total cost over its valid rows (float64)."""
    c, v, k = cost.cpu().numpy(), valid.cpu().numpy(), cols.cpu().numpy()
    return np.array([float(ci[np.nonzero(vi)[0], ki[vi]].sum(dtype=np.float64))
                     for ci, vi, ki in zip(c, v, k)])


def scipy_on_host(cost, valid):
    """``linear_assignment`` as the port did it before the kernel: each
    problem's costs copied to the host and solved by scipy (one round trip
    a stage and image)."""
    from scipy.optimize import linear_sum_assignment

    cols = torch.zeros(valid.shape, dtype=torch.int64)
    for p in range(cost.shape[0]):
        rows = valid[p].nonzero().flatten().cpu()
        if len(rows):
            cols[p, rows] = torch.from_numpy(linear_sum_assignment(cost[p].cpu().numpy()[rows.numpy()])[1])
    return cols.to(cost.device)


@contextlib.contextmanager
def host_matching():
    """``dino_detection_loss`` with ``scipy_on_host`` in place of the kernel:
    the former design, timed beside the kernel on the same outputs."""
    saved = losses_module.linear_assignment
    losses_module.linear_assignment = scipy_on_host
    try:
        yield
    finally:
        losses_module.linear_assignment = saved


def matching_bound_ms(cost, valid):
    """Least time for an assignment: reading the valid rows' costs once (the
    kernel reads no other row), the mask, and writing the columns."""
    P, R, C = cost.shape
    nbytes = int(valid.sum().item()) * C * 4 + valid.numel() + P * R * 8
    return roofline(nbytes, 0)


def hungarian_checks(stamp):
    """The matching kernel against its plain version (the same assignment,
    ties included) and scipy (the valid rows' total cost within 1e-6
    relative; where a problem has more valid rows than columns, scipy's
    assignment of the transposed problem, its costs continuous so its
    optimum is unique) on ``assignment_cases``; each call one launch,
    invalid rows 0; its time per launch beside scipy's host time on the
    same problems."""
    res = {}
    for name, cost, valid in assignment_cases(np.random.default_rng(SEED + 7)):
        before = hungarian.launches
        got = hungarian.linear_assignment(cost, valid)
        torch.cuda.synchronize()
        launched = hungarian.launches - before
        want = hungarian.linear_assignment_plain(cost, valid)
        ref, transposed, scipy_ms = scipy_assignment(cost, valid)
        mine = valid_totals(cost, valid, got)
        short = ~np.isnan(ref)
        rel = float(np.max(np.abs(mine[short] - ref[short]) / np.maximum(np.abs(ref[short]), 1.0), initial=0.0))
        cols = got.cpu().numpy()
        equal_transposed = all(np.array_equal(cols[p], a) for p, a in transposed.items())
        equal = torch.equal(got, want)
        ms = cuda_ms(lambda: hungarian.linear_assignment(cost, valid), 10)
        b_ms, b_by, nbytes, _ = matching_bound_ms(cost, valid)
        shared = hungarian.uses_shared_memory(*cost.shape[1:])
        res[name] = {"equal_to_plain": equal, "max_abs_err": (got - want).abs().max().item(),
                     "cost_rel_err_vs_scipy": rel, "transposed_problems": len(transposed),
                     "transposed_equal_to_scipy": equal_transposed, "ms": ms,
                     "scipy_ms": scipy_ms, "bound_ms": b_ms, "shared_memory": shared}
        print(f"hungarian {name}: equal to the plain version {equal}, valid cost vs scipy rel err "
              f"{rel:.3e} (tol 1e-6), {len(transposed)} of {len(ref)} problems transposed (V > C), "
              f"equal to scipy's {equal_transposed}, {launched} launch; kernel {ms:.4f} ms/launch "
              f"({'shared' if shared else 'global'}-memory state), scipy on the host {scipy_ms:.3f} ms "
              f"(copy included), bound {b_ms * 1e3:.3f} us ({b_by}: {nbytes / 1e6:.3f} MB) [{stamp}]")
        if not equal or rel > 1e-6 or not equal_transposed or launched != 1 or got[~valid].any():
            fail(f"hungarian {name}: the kernel disagrees (equal {equal}, rel {rel:.3e}, transposed "
                 f"equal {equal_transposed}, launches {launched})")
    return res


def matching_timings(problems, reps=20):
    """One step's two matching launches on its own costs: kernel, plain
    version and scipy (copy included) summed over both, and the bound."""
    r = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
         "shapes": [list(c.shape) for c, _ in problems]}
    for cost, valid in problems:
        r["ms"] += cuda_ms(lambda: hungarian.linear_assignment(cost, valid), reps)
        r["plain_ms"] += cuda_ms(lambda: hungarian.linear_assignment_plain(cost, valid), 1, warmup=1)
        r["library_ms"] += statistics.median(scipy_assignment(cost, valid)[2] for _ in range(3))
        r["bound_ms"] += matching_bound_ms(cost, valid)[0]
    r["bound_by"] = "bytes"
    return r


def sync_free_loss(cfg, stamp):
    """``dino_detection_loss`` on the card at the trainbench size's shapes,
    batch 2 (max_gt 32, 7 valid), under ``set_sync_debug_mode("error")``:
    any host synchronisation raises.  Two matching launches a call; the
    step's costs are kept for the timings."""
    h, w = TRAINBENCH_HW
    rng = np.random.default_rng(SEED)
    x = torch.from_numpy((rng.standard_normal((2, h, w, 3)) * 0.1).astype(np.float32)).to(DEVICE)
    mask = torch.zeros(2, h, w, device=DEVICE)
    targets = synthetic_targets(rng, 32, 7, cfg.head.num_classes, DEVICE, batch=2)
    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    with torch.no_grad():
        outputs = model.train_outputs(x, mask)
    del model
    torch.cuda.synchronize()
    hungarian.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        total, logs = dino_detection_loss(outputs, *targets)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    launches = hungarian.launches

    def loss_ms(reps=3):
        return [timed(lambda: dino_detection_loss(outputs, *targets))[1] for _ in range(reps)]

    kernel_ms, host_ms = loss_ms(), []  # in turns: kernel, host, host, kernel
    with host_matching():
        host_ms += loss_ms()
        host_ms += loss_ms()
        host_total = dino_detection_loss(outputs, *targets)[0].item()
    kernel_ms += loss_ms()
    problems = matching_problems(outputs, *targets)
    print(f"sync-free dino_detection_loss {h}x{w} batch 2 (Swin-L's shapes: "
          f"{[list(c.shape) for c, _ in problems]}): no host synchronisation under "
          f"set_sync_debug_mode('error'), {launches} matching launches, loss {total.item():.6f} "
          f"(with scipy on the host {host_total:.6f}), {len(logs)} named losses; loss forward "
          f"{fmt_ms(kernel_ms)} ms, with the matching copied to the host for scipy (the former "
          f"design) {fmt_ms(host_ms)} ms, in turns [{stamp}]")
    if abs(host_total - total.item()) > 1e-6 * abs(host_total):
        fail("the losses with the kernel's matching and with scipy's differ")
    if launches != 2:
        fail(f"dino_detection_loss launched the matching kernel {launches} times, not 2")
    if not all(torch.isfinite(v).item() for v in (total, *logs.values())):
        fail("non-finite losses")
    return {"launches": launches, "loss_ms": kernel_ms, "host_loss_ms": host_ms, "problems": problems}


def cross_matches(outputs_g, outputs_c, targets_c):
    """Each matching problem (stage x image) of the card's and the CPU's
    outputs, each device's costs solved by both solvers (the kernel and the
    plain version).  Per problem: the card's and the CPU's valid gts'
    queries, whether the solvers agree on each device's costs, the largest
    cost difference between the devices over the valid rows, and the total
    valid cost of each device's matches under the other's costs above that
    device's own optimum."""
    targets_g = tuple(t.to(DEVICE) for t in targets_c)
    probs_g = matching_problems(outputs_g, *targets_g)
    probs_c = matching_problems({k: v.cpu() for k, v in outputs_c.items()}, *targets_c)
    rows = []
    for (cg, vg), (cc, vc) in zip(probs_g, probs_c):
        a_g, a_c = hungarian.linear_assignment(cg, vg).cpu(), hungarian.linear_assignment_plain(cc, vc)
        kernel_on_cpu_costs = hungarian.linear_assignment(cc.to(DEVICE), vc.to(DEVICE)).cpu()
        plain_on_card_costs = hungarian.linear_assignment_plain(cg.cpu(), vc)
        cg = cg.cpu()
        for i in range(cg.shape[0]):
            v = vc[i]

            def total(cost, cols):
                return cost[i][v].gather(1, cols[i][v][:, None]).double().sum().item()

            rows.append({
                "card": a_g[i][v], "cpu": a_c[i][v],
                "solvers_agree": (torch.equal(kernel_on_cpu_costs[i], a_c[i])
                                  and torch.equal(plain_on_card_costs[i], a_g[i])),
                "cost_delta": (cg[i][v] - cc[i][v]).abs().max().item() if v.any() else 0.0,
                "n": int(v.sum()),
                "gap_under_cpu_costs": total(cc, a_g) - total(cc, a_c),
                "gap_under_card_costs": total(cg, a_c) - total(cg, a_g),
            })
    return rows


def compare_bf16_steps(cfg, shape_hw, stamp):
    """One bf16-compute train step (``compute_dtype=torch.bfloat16`` over
    fp32 weights) of the full-width Swin-L on the card against the same
    weights stepped on the CPU, at a small padded input.

    The matches first.  Each device's costs are solved by both solvers (the
    kernel and the plain version), which must agree on each: the matching
    is then no cause of a difference.  The encoder stage's matches must be
    equal, or a near-tie of the two devices' costs (each device's matches
    within 2 x n x the largest cost difference of the other's optimum,
    under the other's costs).  The decoder's queries are the encoder's
    top-900 proposals, which the devices pick differently where bf16 scores
    tie or differ in the last bit, so its matches are compared as encoder
    tokens and printed with the top-k agreement as their cause.  Then the
    loss within 2e-2 relative; every parameter fp32 after the step and every
    entry with a nonzero gradient moved; 12 + 12 MSDA launches and 2
    matching launches on the card."""
    h, w = shape_hw
    rng = np.random.default_rng(SEED + 2)
    img = torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32))
    mask = torch.zeros(1, h, w)
    mask[:, int(h * 0.75):, :] = 1.0
    mask[:, :, int(w * 0.875):] = 1.0
    cpu_args = (img, mask, *synthetic_targets(rng, 8, 3, cfg.head.num_classes, "cpu"))
    dev_args = tuple(t.to(DEVICE) for t in cpu_args)
    cpu = build_codetr(cfg, device="cpu", seed=SEED)
    gpu = copy.deepcopy(cpu).to(DEVICE)

    def bf16(model, fn, args):
        with torch.no_grad():
            return run_in_dtype(model, torch.bfloat16, fn, *args[:2])

    outs = [bf16(m, lambda m, x, mk: m.train_outputs(x, mk), a) for m, a in ((gpu, dev_args), (cpu, cpu_args))]
    aux = [bf16(m, lambda m, x, mk: m.query_head.run_transformer(m.features(x), mk)[2], a)
           for m, a in ((gpu, dev_args), (cpu, cpu_args))]
    topk = [a["topk_idx"][0].cpu() for a in aux]
    scores = aux[0]["enc_class"].float().max(-1)[0][0].cpu()[topk[0]]
    k = len(topk[0])
    same_position = int((topk[0] == topk[1]).sum())
    same_set = len(set(topk[0].tolist()) & set(topk[1].tolist()))
    tied = int((torch.unique(scores, return_counts=True)[1] > 1).sum())
    del aux
    rows = cross_matches(*outs, cpu_args[2:])
    del outs
    nl = cfg.head.transformer.num_decoder_layers  # problems 0..nl-1: the decoder's, then the encoder's
    disagree = [i for i, r in enumerate(rows) if not r["solvers_agree"]]
    enc = rows[nl]
    enc_gap = max(enc["gap_under_cpu_costs"], enc["gap_under_card_costs"])
    enc_ok = torch.equal(enc["card"], enc["cpu"]) or enc_gap <= 2 * enc["n"] * enc["cost_delta"]
    same_token = [int((topk[0][r["card"]] == topk[1][r["cpu"]]).sum()) for r in rows[:nl]]
    start = {n: p.detach().clone() for n, p in gpu.named_parameters()}
    per = launches_per_forward(cfg)
    msda.launches = msda.launches_bwd = hungarian.launches = 0
    loss_g = make_train_step(gpu, adamw(gpu), compute_dtype=torch.bfloat16)(*dev_args).item()
    torch.cuda.synchronize()
    counts = (msda.launches, msda.launches_bwd, hungarian.launches)
    t0 = time.perf_counter()
    loss_c = make_train_step(cpu, adamw(cpu), compute_dtype=torch.bfloat16)(*cpu_args).item()
    cpu_s = time.perf_counter() - t0
    not_fp32 = [n for m in (gpu, cpu) for n, p in m.named_parameters() if p.dtype != torch.float32]
    nonzero = stuck = 0
    for n, p in gpu.named_parameters():
        nz = p.grad != 0
        nonzero += int(nz.sum())
        stuck += int((nz & (p.detach() == start[n])).sum())
    loss_err = abs(loss_g - loss_c) / abs(loss_c)
    print(f"Swin-L bf16-compute train step {h}x{w} card vs CPU: the two solvers agree on each device's "
          f"costs in all {len(rows)} problems but {disagree}; encoder stage matches card "
          f"{enc['card'].tolist()} vs CPU {enc['cpu'].tolist()} (costs differ by up to "
          f"{enc['cost_delta']:.3e}; gaps {enc['gap_under_cpu_costs']:.3e} / "
          f"{enc['gap_under_card_costs']:.3e}, near-tie bound {2 * enc['n'] * enc['cost_delta']:.3e}); "
          f"decoder: the top-{k} proposals agree at {same_position} positions and {same_set} by set "
          f"({tied} groups of equal bf16 scores on the card), so its {nl} stages' valid gts match the "
          f"same encoder token in {same_token} of {enc['n']}; loss {loss_g:.6f} vs {loss_c:.6f} (rel "
          f"err {loss_err:.3e}, tol 2e-2); parameters not fp32 {not_fp32}; {nonzero} gradient entries "
          f"nonzero, {stuck} of them not moved; launches (MSDA forward, backward, matching) {counts}; "
          f"CPU step {cpu_s:.1f} s [{stamp}]")
    if disagree or not enc_ok:
        fail(f"bf16 step: the solvers disagree on the same costs ({disagree}) or the encoder stage's "
             f"matches differ beyond a rounding tie")
    if loss_err > 2e-2 or not_fp32 or stuck or counts != (per, per, 2):
        fail("the bf16 train step on the card disagrees with the CPU's")
    return {"loss_rel_err": loss_err, "launches": counts, "topk_same_position": same_position,
            "topk_same_set": same_set, "decoder_same_token": same_token}

def launches_per_forward(cfg) -> int:
    tc = cfg.head.transformer
    return tc.num_encoder_layers + tc.num_decoder_layers


def compare_models(cfg, shape_hw, stamp, label="Swin-L"):
    """A full-width model on the card (kernel path) against the same weights
    on the CPU (plain path), fp32, at a small padded input."""
    h, w = shape_hw
    rng = np.random.default_rng(SEED + 1)
    img = torch.from_numpy(rng.standard_normal((1, h, w, 3)).astype(np.float32))
    mask = torch.zeros(1, h, w)
    mask[:, int(h * 0.75):, :] = 1.0
    mask[:, :, int(w * 0.875):] = 1.0
    cpu = build_codetr(cfg, device="cpu", seed=SEED)
    gpu = copy.deepcopy(cpu).to(DEVICE)

    def run(model, x, m):
        feats = model.features(x)
        state, refs, aux = model.query_head.run_transformer(feats, m)
        return feats, aux, model.query_head.decode(state, refs, (h, w))

    with torch.no_grad():
        c_feats, c_aux, (c_boxes, c_scores, c_labels) = run(cpu, img, mask)
        before = msda.launches
        g_feats, g_aux, (g_boxes, g_scores, g_labels) = run(gpu, img.to(DEVICE), mask.to(DEVICE))
        torch.cuda.synchronize()
    if msda.launches - before != launches_per_forward(cfg):
        fail(f"reference check launched the kernel {msda.launches - before} times, "
             f"not {launches_per_forward(cfg)}")

    def rel(g, c):
        return ((g.cpu().float() - c).abs().max() / c.abs().max()).item()

    feat_err = max(rel(g, c) for g, c in zip(g_feats, c_feats))
    mem_err = rel(g_aux["memory"], c_aux["memory"])
    cls_err = rel(g_aux["enc_class"], c_aux["enc_class"])
    # proposals picked differently on the two devices (near-tied top-k)
    k = c_aux["topk_idx"].shape[1]
    shared = len(set(c_aux["topk_idx"][0].tolist()) & set(g_aux["topk_idx"][0].cpu().tolist()))
    score_err = (g_scores.cpu() - c_scores).abs().max().item()
    # set-wise match: near-tied top-k entries may swap order between devices
    gb, gl = g_boxes.cpu()[0].numpy(), g_labels.cpu()[0].numpy()
    cb, cl = c_boxes[0].numpy(), c_labels[0].numpy()
    used = np.zeros(len(gb), bool)
    unmatched = 0
    for b, lab in zip(cb, cl):
        cand = np.where((gl == lab) & ~used)[0]
        d = np.abs(gb[cand] - b).max(axis=1) if len(cand) else np.array([np.inf])
        if d.min() > MODEL_BOX_TOL:
            unmatched += 1
            continue
        used[cand[np.argmin(d)]] = True
    print(f"{label} {h}x{w} card vs CPU: features rel err {feat_err:.3e}, encoder memory "
          f"{mem_err:.3e}, encoder class logits {cls_err:.3e} (tol 2e-4 each); "
          f"{k - shared}/{k} top-k proposals differ; scores err {score_err:.3e} (tol {MODEL_SCORE_TOL}), "
          f"unmatched boxes {unmatched}/{len(cb)} at {MODEL_BOX_TOL} px (tol {len(cb) // 100}) [{stamp}]")
    if (max(feat_err, mem_err, cls_err) > 2e-4 or score_err > MODEL_SCORE_TOL
            or unmatched > len(cb) // 100):
        fail("the model on the card disagrees with the CPU reference")


def check_detections(dets, n_expected, max_per_img):
    if len(dets) != n_expected:
        fail(f"{len(dets)} results for {n_expected} images")
    for d in dets:
        if d.boxes.shape != (max_per_img, 4) or d.scores.shape != (max_per_img,):
            fail(f"bad shapes {d.boxes.shape} {d.scores.shape}")
        if d.keep.dtype != bool or d.keep.shape != (max_per_img,) or not d.keep.any():
            fail("keep must be a non-empty (N,) bool mask")
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores[d.keep]).all()):
            fail("non-finite detections")


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = fn()
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def postprocess_fn(cfg, nms_type):
    """The ``Inferencer``'s postprocess at the config's thresholds:
    (boxes, scores, labels, scale factors) -> (boxes, scores, labels, keep)."""
    head = cfg.head
    kw = dict(score_threshold=head.score_threshold, iou_threshold=head.nms_iou_threshold, nms_type=nms_type,
              nms_sigma=head.nms_sigma, nms_min_score=head.nms_min_score)
    return lambda b, s, l, sf: postprocess_detections(b, s, l, scale_factor=sf, **kw)


def raw_batch(model, cfg, height, width, images):
    """The model's raw (boxes, scores, labels) for ``images``, one forward
    each, stacked as one batch, and their (n, 1, 4) scale factors."""
    outs, sfs = [], []
    with torch.inference_mode():
        for im in images:
            x, mk, sf, _ = preprocess(im, height, width, cfg.preprocess, device=DEVICE)
            outs.append(model(x[None], mk[None]))
            sfs.append([sf[0], sf[1], sf[0], sf[1]])
    raw = tuple(torch.cat(t) for t in zip(*outs))
    return raw + (torch.tensor(sfs, dtype=torch.float32, device=DEVICE)[:, None, :],)


def postprocess_times(args, post):
    """ms per image of the postprocess ``post`` on the batch ``args`` cut to
    each of POST_BATCHES: the captured program (an ``aot.Replay``, as the
    ``Inferencer`` runs it: inputs copied in, outputs cloned out) and the
    eager batched call, both between CUDA events; at the largest batch also
    the former design, one eager call per image."""
    out = {}
    with torch.inference_mode():
        for bs in POST_BATCHES:
            a = tuple(t[:bs] for t in args)
            replay = Replay(post, a)
            out[f"captured_bs{bs}"] = cuda_ms(lambda: replay(*a), 20) / bs
            out[f"eager_bs{bs}"] = cuda_ms(lambda: post(*a), 3, warmup=1) / bs
        bs = POST_BATCHES[-1]
        a = tuple(t[:bs] for t in args)
        out[f"per_image_eager_bs{bs}"] = cuda_ms(
            lambda: [post(*(t[j:j + 1] for t in a)) for j in range(bs)], 2, warmup=1) / bs
    return out


def post_text(t) -> str:
    bs = POST_BATCHES[-1]
    return (f"captured {t['captured_bs1']:.3f} (batch 1), {t[f'captured_bs{bs}']:.3f} (batch {bs}); eager "
            f"batched {t['eager_bs1']:.3f}, {t[f'eager_bs{bs}']:.3f}; one eager call per image at batch {bs} "
            f"{t[f'per_image_eager_bs{bs}']:.3f} ms per image")


def ladder_errors(got, want) -> dict:
    """The card's postprocess against the CPU's at the parity ladder of
    ``test_postprocess_matches_jax``: keep masks and labels equal, scores
    and boxes within 1e-6 (absolute and relative); -inf where the other is."""
    g = [t.cpu() for t in got]
    err = {"keep_differ": int((g[3] != want[3]).sum()), "labels_differ": int((g[2] != want[2]).sum())}
    for name, i in (("scores", 1), ("boxes", 0)):
        a, b = g[i].double(), want[i].double()
        fin = torch.isfinite(b)
        err[f"{name}_inf_differ"] = int((torch.isfinite(a) != fin).sum() + (a[~fin] != b[~fin]).sum())
        diff = (a[fin] - b[fin]).abs()
        err[name] = float(diff.max()) if diff.numel() else 0.0
        err[f"{name}_over"] = int((diff > 1e-6 + 1e-6 * b[fin].abs()).sum())
    return err


def postprocess_checks(model, cfg, raw, stamp):
    """The slice's path on the model's own outputs (``raw``: a batch of 4
    and its scale factors): for nms, soft_nms and soft_nms_gaussian at
    batch 1 and 4, the captured postprocess (``aot.Replay``, as the
    ``Inferencer`` runs it) against the eager batched call on the card, bit
    for bit, and against the same inputs postprocessed on the CPU
    (``ladder_errors``), each timed; then one ``Inferencer`` call over 9
    images at batch 4 (three batches, the last padded) against three
    separate calls: equal, each batch its own detections, 12 forward-kernel
    launches a batch, one captured program replayed 6 times."""
    out = {}
    with torch.inference_mode():
        for nms_type in NMS_TYPES:
            post = postprocess_fn(cfg, nms_type)
            for bs in POST_BATCHES:
                a = tuple(t[:bs] for t in raw)
                eager = post(*a)
                got = Replay(post, a)(*a)
                exact = all(torch.equal(x, y) for x, y in zip(got, eager))
                err = ladder_errors(got, post(*(t.cpu() for t in a)))
                kept = int(got[3].sum())
                print(f"postprocess {nms_type} batch {bs} on the Swin-L {HEIGHT}x{WIDTH} fp32 model's outputs: "
                      f"captured {'equal' if exact else 'NOT equal'} to eager bit for bit; against the CPU "
                      f"keep masks differing {err['keep_differ']}, labels {err['labels_differ']}, max score "
                      f"diff {err['scores']:.3e}, box {err['boxes']:.3e} px (tol 1e-6 + 1e-6 relative); "
                      f"{kept} kept [{stamp}]")
                if not exact:
                    fail(f"the captured postprocess ({nms_type}, batch {bs}) differs from the eager one")
                if any(err[k] for k in ("keep_differ", "labels_differ", "scores_inf_differ", "boxes_inf_differ",
                                        "scores_over", "boxes_over")):
                    fail(f"the card's postprocess ({nms_type}, batch {bs}) differs from the CPU's: {err}")
                out[f"{nms_type} batch {bs}"] = err
            t = out[f"{nms_type} times"] = postprocess_times(raw, post)
            print(f"postprocess {nms_type} on the model's outputs: {post_text(t)} [{stamp}]")

    rng = np.random.default_rng(SEED + 12)
    nine = [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in EVAL_SIZES[:9]]
    inf = Inferencer(model, height=HEIGHT, width=WIDTH, batch_size=4, device=DEVICE)
    msda.launches = msda.launches_qm = msda.launches_bwd = 0
    together = inf(nine)
    launches = (msda.launches, msda.launches_qm, msda.launches_bwd)
    apart = inf(nine[:4]) + inf(nine[4:8]) + inf(nine[8:])
    differ = sum(int(not np.array_equal(getattr(g, f), getattr(w, f)))
                 for g, w in zip(together, apart) for f in ("boxes", "scores", "labels", "keep"))
    replays = [p.calls for p in inf.postprocess_programs.values()]
    print(f"Inferencer Swin-L {HEIGHT}x{WIDTH} fp32 batch 4, 9 images in one call (3 batches, the last padded) "
          f"against 3 calls: {differ} fields differing; launches (forward, q-minor, backward) {launches} in the "
          f"one call; captured postprocess programs {len(replays)}, replays {replays} [{stamp}]")
    check_detections(together, 9, cfg.head.max_per_img)
    if differ or len(together) != 9:
        fail("a multi-batch Inferencer call did not return each batch's own detections")
    if launches != (3 * launches_per_forward(cfg), 0, 0) or replays != [6]:
        fail(f"the multi-batch Inferencer launched {launches} and replayed {replays}, not "
             f"({3 * launches_per_forward(cfg)}, 0, 0) and [6]")
    out["multi_batch"] = {"differ": differ, "launches": launches[0], "replays": replays}
    return out


def serve(cfg, height, width, dtype, images, warmup, stamp, post_checks=False):
    """One serving configuration: the ``Inferencer`` at batch 1 after one
    warm-up image, then each of ``images`` timed on the host clock with the
    launch counts set to 0 before and read after (each forward must launch
    the forward kernel once per encoder and decoder layer, and no other);
    then one forward of the last image timed piece by piece, and the
    postprocess on the model's outputs for the warm-up image and
    ``images`` (repeated to a batch of 4) timed captured and eager
    (``postprocess_times``); with ``post_checks``, ``postprocess_checks``."""
    model = build_codetr(cfg, dtype=dtype, device=DEVICE, seed=SEED)
    inf = Inferencer(model, height=height, width=width, batch_size=1, device=DEVICE)
    inf([warmup])  # library handles, allocator, cached masks
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    msda.launches = msda.launches_qm = msda.launches_bwd = 0
    dets, latencies = [], []
    for im in images:
        d, t = timed(lambda: inf([im]))
        dets += d
        latencies.append(t)
    launches = (msda.launches, msda.launches_qm, msda.launches_bwd)
    peak = torch.cuda.max_memory_allocated()
    check_detections(dets, len(images), cfg.head.max_per_img)
    per_forward = launches_per_forward(cfg)
    if launches != (per_forward * len(images), 0, 0):
        fail(f"serving {height}x{width} {dtype} launched (forward, q-minor, backward) kernels "
             f"{launches}, not ({per_forward * len(images)}, 0, 0)")

    with torch.inference_mode():
        pre, t_pre = timed(lambda: preprocess(images[-1], height, width, cfg.preprocess, device=DEVICE))
        x, mk = pre[0][None], pre[1][None]
        feats, t_feat = timed(lambda: model.features(x))
        det, t_det = timed(lambda: model.detect(feats, mk))
    del feats, det
    raw = raw_batch(model, cfg, height, width, (([warmup] + list(images)) * 4)[:4])
    t_post = postprocess_times(raw, postprocess_fn(cfg, cfg.head.nms_type))
    checks = postprocess_checks(model, cfg, raw, stamp) if post_checks else None
    del model, inf, raw
    torch.cuda.empty_cache()
    return {"latencies": latencies, "split": (t_pre, t_feat, t_det, t_post), "peak": peak,
            "held": held, "launches": launches[0], "kept": [int(d.keep.sum()) for d in dets],
            "nms_type": cfg.head.nms_type, "postprocess": checks}


def print_serving(label, r, images, stamp):
    for im, t in zip(images, r["latencies"]):
        print(f"latency {label} image {im.shape[:2]}: {t:.2f} ms [{stamp}]")
    print(f"latency {label} median: {statistics.median(r['latencies']):.2f} ms per image [{stamp}]")
    t_pre, t_feat, t_det, t_post = r["split"]
    print(f"{label} split, one image: preprocess {t_pre:.2f} ms, backbone+neck {t_feat:.2f} ms, "
          f"head {t_det:.2f} ms; postprocess ({r['nms_type']}) {post_text(t_post)} [{stamp}]")
    print(f"peak memory allocated, {label}: {r['peak'] / 2**30:.3f} GiB, of which "
          f"{r['held'] / 2**30:.3f} GiB held before the serving path [{stamp}]")


def shift_inputs(hw, far=0.1):
    """The gate's geometry (``verify_inputs``: each tap at its query's anchor
    on its target level plus up to 3 px of jitter, 8 heads, 4 points, head
    dim 32, 5 levels) at an input size, value fp32, with a share ``far`` of
    the taps moved 8-12 px on both axes (out of every window of radius 5)."""
    value, shapes, x, y, w = verify_inputs(*hw, torch.float32)
    if far:
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
        L = len(shapes)
        moved = torch.rand(x.shape, generator=g, device=DEVICE) < far

        def step(sizes):
            mag = torch.rand(x.shape, generator=g, device=DEVICE) * 4 + 8
            sign = torch.where(torch.rand(x.shape, generator=g, device=DEVICE) < 0.5, -1.0, 1.0)
            return mag * sign / torch.tensor(sizes, dtype=torch.float32, device=DEVICE).view(1, 1, L, 1, 1)

        x = torch.where(moved, x + step([ww for _, ww in shapes]), x).contiguous()
        y = torch.where(moved, y + step([hh for hh, _ in shapes]), y).contiguous()
    return value, shapes, x, y, w


# (radius, max_window) of the K4 checks: the module's default radius (5) and
# the op's (4) at the Pallas kernel's window limit, then a limit of 13 that
# sends every cross-level pair (W = 17) through the coarse-pair escape
SHIFT_CASES = ((5, 31), (4, 31), (5, 13))
GRID_RADIUS = 5  # MSDAConfig.grid_radius


def shift_checks(stamp):
    """The shift-window kernel (K4) against its plain version, unchecked
    (truncated) function with far taps, at the 768x1152 and R50 608x608
    encoder shapes, fp32 and bf16 values, for each of ``SHIFT_CASES``."""
    errs = {}
    for hw in ((HEIGHT, WIDTH), R50_SERVING[0][:2]):
        value, shapes, x, y, w = shift_inputs(hw)
        for radius, max_window in SHIFT_CASES:
            coarse = sum(p.coarse for row in msda_grid.pair_plans(shapes, radius, max_window) for p in row)
            errs[(hw, radius, max_window)] = check_kernel(
                f"shift-window MSDA {hw[0]}x{hw[1]} radius {radius} max_window {max_window} "
                f"({coarse} coarse pairs, Q={value.shape[1]})", value,
                lambda v: msda_grid.msda_grid_shift_qm(v, shapes, x, y, w, radius=radius,
                                                       max_window=max_window),
                lambda v: msda_grid.msda_shift_plain(v, shapes, x, y, w, radius, max_window), stamp,
            )
        del value, x, y, w
    return errs


def shift_adversarial_taps(shapes, radius, max_window, batch=2, heads=8, dim=32, points=4):
    """K4's tile-adversarial taps, q-minor, batch ``batch``: on each axis, at
    random, the window coordinate ``t = pos - anchor + (R + 1)`` exactly on
    cell 0 or on cell W - 1, one cell outside (a corner in, a corner out),
    wholly outside (both corners out), on the first or last pixel of the
    tile's window of the pair (``shift_tile_plan``), or inside; 10% of the
    taps far (anywhere within half a level of it).  Each location is nudged
    by an ulp where needed so that the kernel's rounded ``loc * size - 0.5``
    lands exactly on the intended pixel.  Returns value (batch, K, h, d)
    fp32, x, y, w (batch, h, L, P, K)."""
    plan = msda_grid.shift_tile_plan(shapes, torch.float32, radius, max_window)
    ax, ay, r1 = msda_grid._query_anchors(msda_grid._key(shapes), radius, max_window, DEVICE)
    wy0, wx0, wh, ww, _ = msda_tiles.query_windows(plan, DEVICE)  # (K, L)
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    K, L = ax.shape
    shape = (batch, heads, L, points, K)

    def axis(anchor, start, size, n):
        n = torch.tensor(n, dtype=torch.float32, device=DEVICE).view(1, 1, L, 1, 1)
        a, s0, z, c1 = (t.float().T.reshape(1, 1, L, 1, K) for t in (anchor, start, size, r1))
        last = 2 * c1  # W - 1
        u = torch.rand(shape, generator=g, device=DEVICE) * 0.98 + 0.01
        t = torch.stack(torch.broadcast_tensors(
            torch.zeros_like(u), last, -u, last + u, -1 - u, last + 1 + u,
            s0 - a + c1, s0 + z - 1 - a + c1, u * last))
        kind = torch.randint(0, len(t), shape, generator=g, device=DEVICE)
        pos = t.gather(0, kind[None])[0] + a - c1
        far = torch.rand(shape, generator=g, device=DEVICE) < 0.1
        pos = torch.where(far, (torch.rand(shape, generator=g, device=DEVICE) * 2 - 0.5) * n, pos)
        loc = (pos + 0.5) / n
        for _ in range(2):  # land loc * n - 0.5 on pos where fp32 allows
            back = loc * n - 0.5
            loc = torch.where(back < pos, torch.nextafter(loc, loc + 1),
                              torch.where(back > pos, torch.nextafter(loc, loc - 1), loc))
        return loc.contiguous()

    x = axis(ax, wx0, ww, [w_ for _, w_ in shapes])
    y = axis(ay, wy0, wh, [h_ for h_, _ in shapes])
    w = torch.randn(batch, K, heads, L * points, generator=g, device=DEVICE).softmax(-1)
    w = w.reshape(batch, K, heads, L, points).permute(0, 2, 3, 4, 1).contiguous()
    value = torch.randn(batch, K, heads, dim, generator=g, device=DEVICE)
    return value, x, y, w


def shift_adversarial_checks(stamp):
    """K4 against its plain version on ``shift_adversarial_taps`` at both
    serving sizes, batch 2, radius 5 with idealised anchors (``max_window``
    31) and with every cross-level pair on the coarse-pair escape (13), fp32
    and bf16 values, with the tolerances of ``check_kernel``; prints the
    share of the truncated function's corner reads that the plan serves
    from shared memory."""
    res = {}
    for hw in ((HEIGHT, WIDTH), R50_SERVING[0][:2]):
        shapes = level_shapes(*hw)
        for radius, max_window in ((5, 31), (5, 13)):
            value, x, y, w = shift_adversarial_taps(shapes, radius, max_window)
            plan = msda_grid.shift_tile_plan(shapes, torch.float32, radius, max_window)
            served, total = msda_grid.shift_staged_share(plan, shapes, x, y, w, radius, max_window)
            key = f"{hw[0]}x{hw[1]} radius {radius} max_window {max_window}"
            print(f"K4 tile-adversarial taps {key}, batch 2: {served} of {total} corner reads in a "
                  f"staged window ({served / total:.4f})")
            errs = check_kernel(
                f"shift-window MSDA {key} tile-adversarial (batch 2)", value,
                lambda v: msda_grid.msda_grid_shift_qm(v, shapes, x, y, w, radius=radius,
                                                       max_window=max_window),
                lambda v: msda_grid.msda_shift_plain(v, shapes, x, y, w, radius, max_window), stamp,
            )
            res[key] = {**errs, "staged_share": served / total}
            del value, x, y, w
    torch.cuda.empty_cache()
    return res


def rel_to_scale(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / max(want.abs().max().item(), 1.0)).item()


def dispatch_checks(stamp):
    """The corrected ``msda_grid_qm(impl="grid_pallas" | "grid")`` at
    768x1152 (radius 5), fp32, against the exact ``msda_reference_qm``: with far taps
    each call launches K4 once and K3 once for the out-of-envelope taps; on
    the jitter-only taps (none out) K4 alone.  Then the gradient of the
    ``"grid_pallas"`` call against the plain backward (the exact VJP): the
    backward kernel on q-minor strides, once for the window part and once
    for the correction.  Tolerance 1e-5 of each result's scale."""
    value, shapes, x, y, w = shift_inputs((HEIGHT, WIDTH))
    want = msda.msda_reference_qm(value, shapes, x, y, w)
    res = {"out_of_envelope": {}}
    for impl in ("grid_pallas", "grid"):
        msda.launches_shift = msda.launches_qm = 0
        got = msda.msda_grid_qm(value, shapes, x, y, w, impl=impl, radius=GRID_RADIUS)
        torch.cuda.synchronize()
        launched = (msda.launches_shift, msda.launches_qm)
        count = res["out_of_envelope"][impl] = msda.last_out_of_envelope
        err = res[impl] = rel_to_scale(got, want)
        print(f"corrected {impl} dispatch {HEIGHT}x{WIDTH} radius {GRID_RADIUS}, far taps: {count} of "
              f"{w.numel()} taps out of the envelope; (K4, K3) launches {launched}; error "
              f"{err:.3e} of scale (tol 1e-5) [{stamp}]")
        if count == 0 or launched != (1, 1) or not err < 1e-5:
            fail(f"corrected {impl} dispatch: {count} out, launches {launched}, error {err}")

    value0, _, x0, y0, w0 = shift_inputs((HEIGHT, WIDTH), far=0.0)
    msda.launches_shift = msda.launches_qm = 0
    got = msda.msda_grid_qm(value0, shapes, x0, y0, w0, impl="grid_pallas", radius=GRID_RADIUS)
    torch.cuda.synchronize()
    launched, count = (msda.launches_shift, msda.launches_qm), msda.last_out_of_envelope
    err = rel_to_scale(got, msda.msda_reference_qm(value0, shapes, x0, y0, w0))
    print(f"corrected grid_pallas dispatch, jitter-only taps: {count} out; (K4, K3) launches "
          f"{launched}; error {err:.3e} of scale (tol 1e-5) [{stamp}]")
    if count != 0 or launched != (1, 0) or not err < 1e-5:
        fail(f"jitter-only dispatch: {count} out, launches {launched}, error {err}")
    del value0, x0, y0, w0, got

    g = torch.randn(want.shape, generator=torch.Generator(device=DEVICE).manual_seed(SEED + 8),
                    device=DEVICE)
    leaves = [t.clone().requires_grad_() for t in (value, x, y, w)]
    msda.launches_bwd = 0
    msda.msda_grid_qm(leaves[0], shapes, *leaves[1:], impl="grid_pallas", radius=GRID_RADIUS).backward(g)
    torch.cuda.synchronize()
    plain = plain_backward_qm(value, shapes, x, y, w, g)
    grad_errs = [rel_to_scale(t.grad, p) for t, p in zip(leaves, plain)]
    print(f"corrected grid_pallas dispatch gradient: backward launches {msda.launches_bwd}; "
          f"(value, x, y, w) errors {', '.join(f'{e:.3e}' for e in grad_errs)} of scale "
          f"(tol 1e-5) [{stamp}]")
    if msda.launches_bwd != 2 or not max(grad_errs) < 1e-5:
        fail("the corrected dispatch's gradient disagrees with the plain backward")
    res["grad"] = max(grad_errs)
    return res


def encoder_stage(cfg, image, stamp, reps=3):
    """The flagship's encoder stage with the shift-window impl: the Swin-L
    model (seed-0 weights, fp32) on one image at 768x1152, its six encoder
    layers run by ``CoDinoTransformer.encode`` through a
    ``DetrTransformerEncoder(msda_impl="grid_pallas")`` carrying the same
    weights, against the model's own (``"auto"``) encoder: memory within
    1e-4 of its scale.  The launch counts are set to 0 just before the
    grid_pallas run and read just after: one K4 launch per layer, one K3
    launch per layer with taps out of the envelope, no K1.  The ``"auto"``
    run also counts, per layer, the corner reads of the model's own taps
    that the tiled encoder kernel serves from shared memory (the staged
    share; at least 0.7 overall).  Returns the per-layer out-of-envelope
    counts and staged shares, the launches and both impls' times."""
    from codetr_torch.models.transformer import DetrTransformerEncoder
    from codetr_torch.utils.preprocess import preprocess

    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    head, tf = model.query_head, model.query_head.transformer
    grid_enc = DetrTransformerEncoder(tf.cfg, "grid_pallas").to(DEVICE)
    grid_enc.load_state_dict(tf.encoder.state_dict())
    counts = []
    for layer in grid_enc.layers:
        layer.attentions[0].register_forward_hook(lambda *_: counts.append(msda.last_out_of_envelope))
    with torch.no_grad():
        pre = preprocess(image, HEIGHT, WIDTH, cfg.preprocess, device=DEVICE)
        feats = model.features(pre[0][None])
        masks, pos = head.level_masks_and_pos(feats, pre[1][None])
        torch.cuda.synchronize()
        msda.launches = msda.launches_qm = msda.launches_shift = 0
        mem_grid = tf.encode(feats, masks, pos, encoder=grid_enc)[0]
        torch.cuda.synchronize()
        launches = {"msda_shift_fwd": msda.launches_shift, "msda_qm_fwd": msda.launches_qm,
                    "msda_fwd": msda.launches}
        layer_counts = list(counts)
        with rehearsal.capture_encoder_taps() as calls:  # each layer's taps under its tile plan
            mem_auto = tf.encode(feats, masks, pos)[0]
        shares = [c["share"] for c in calls]
        err = rel_to_scale(mem_grid, mem_auto)
        times = {}
        for impl, enc in (("grid_pallas", grid_enc), ("auto", None)):
            times[impl] = []
            for _ in range(reps):
                _, t = timed(lambda: tf.encode(feats, masks, pos, encoder=enc))
                times[impl].append(t)
    n_layers, attn = len(grid_enc.layers), tf.cfg.encoder_layer.attn
    n_taps = mem_grid.shape[1] * attn.num_heads * attn.num_levels * attn.num_points
    corrected = sum(c > 0 for c in layer_counts)
    share = sum(a for a, _ in shares) / sum(b for _, b in shares)
    print(f"Swin-L encoder's own taps {HEIGHT}x{WIDTH} (seed-0 weights, one 900x1600 image): "
          f"staged share per layer {[round(a / b, 6) for a, b in shares]}, overall {share:.6f} "
          f"(corner reads in a staged window of the tiled encoder kernel; at least 0.7) [{stamp}]")
    if len(shares) != n_layers or not share >= 0.7:
        fail(f"staged share {share} over {len(shares)} layers")
    print(f"Swin-L encoder stage {HEIGHT}x{WIDTH} fp32, grid_pallas vs auto: memory error "
          f"{err:.3e} of scale (tol 1e-4); launches {launches}; out-of-envelope taps per layer "
          f"{layer_counts} of {n_taps}; encoder stage ms grid_pallas "
          f"{fmt_ms(times['grid_pallas'])}, auto {fmt_ms(times['auto'])} [{stamp}]")
    want = {"msda_shift_fwd": n_layers, "msda_qm_fwd": corrected, "msda_fwd": 0}
    if launches != want or not err < 1e-4 or not torch.isfinite(mem_grid).all():
        fail(f"encoder stage: launches {launches} (want {want}), memory error {err}")
    del model, grid_enc, feats, mem_grid, mem_auto
    torch.cuda.empty_cache()
    return {"launches": launches, "out_of_envelope": layer_counts, "err": err, "ms": times,
            "staged_share": share, "staged_share_per_layer": [a / b for a, b in shares]}


def unstaged(plan):
    """``plan`` with no pair staged: every corner read from global memory."""
    return replace(plan, staged=tuple(tuple(False for _ in row) for row in plan.staged))


def shift_direct_ms(v, shapes, x, y, w, reps):
    """K4's kernel with no pair staged (the direct gather through the same
    kernel): the plan swapped for the timing only."""
    plan_fn = msda_grid.shift_tile_plan
    msda_grid.shift_tile_plan = lambda *a, **k: unstaged(plan_fn(*a, **k))
    try:
        return cuda_ms(functools.partial(msda_grid.msda_grid_shift_qm, v, shapes, x, y, w,
                                         radius=GRID_RADIUS), reps)
    finally:
        msda_grid.shift_tile_plan = plan_fn


def shift_timings(stamp):
    """K4 per call at 768x1152 (radius 5, the jitter-only taps: every tap in
    its window, so the truncated function is the exact one and the bytes
    bound counts the rows the taps touch), fp32 and bf16, beside its plain
    version, K3 on the same taps and the kernel with no pair staged."""
    value, shapes, x, y, w = shift_inputs((HEIGHT, WIDTH), far=0.0)
    plan = msda_grid.shift_tile_plan(shapes, torch.float32, GRID_RADIUS)
    served, total = msda_grid.shift_staged_share(plan, shapes, x, y, w, GRID_RADIUS)
    per_call = {"staged_share": served / total}
    for name, v in (("encoder", value), ("encoder_bf16", value.to(torch.bfloat16))):
        b_ms, b_by, nbytes, flops = bound_ms(v, shapes, *from_qm(x, y, w), v.dtype)
        r = per_call[name] = {
            "ms": cuda_ms(functools.partial(msda_grid.msda_grid_shift_qm, v, shapes, x, y, w,
                                            radius=GRID_RADIUS), 20),
            "plain_ms": cuda_ms(functools.partial(msda_grid.msda_shift_plain, v, shapes, x, y, w,
                                                  GRID_RADIUS), 3),
            "k3_ms": cuda_ms(functools.partial(msda.msda_grid_qm, v, shapes, x, y, w), 20),
            "direct_gather_ms": shift_direct_ms(v, shapes, x, y, w, 20),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        }
        print(f"msda_shift_fwd {name} (K = {v.shape[1]}, radius {GRID_RADIUS}): kernel "
              f"{r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, K3 on the same taps "
              f"{r['k3_ms']:.4f} ms/call, no pair staged {r['direct_gather_ms']:.4f} ms/call, "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
              f"staged share {served / total:.6f} [{stamp}]")
    return per_call


def gatherbench_phase(stamp, built):
    """K5: each op's kernel against its plain version at every size of the
    sweep and at the tail sizes it never reaches (the gathers and idxadd bit
    for bit; fma1 and splat2, whose kernels round differently, within 1e-6
    of the checksum's scale), the `I2F` instructions of the built library,
    gather_sub's clusters against what the card holds at once, then the
    sweep itself, with the launch counts set to 0 just before and read just
    after: each case's kernel time beside its bound, its launch floor (the
    empty kernel at its geometry) and, for the gathers, the shared-memory
    wavefront figure."""
    from codetr_torch.tools import gatherbench as gb

    errs = {}
    checks = [(key, op, size, dtype) for key, op, size, dtype in gb.cases()]
    checks += [(f"tail_{op}_{'x'.join(map(str, size))}_{str(dtype).split('.')[-1]}", op, size, dtype)
               for op, size, dtype in gb.TAIL_CASES]
    for key, op, size, dtype in checks:
        inputs = gb.make_inputs(op, size, dtype)
        got, want = gb.KERNEL[op](*inputs), gb.PLAIN[op](*inputs)
        torch.cuda.synchronize()
        err = errs[key] = (got - want).abs().max().item()
        tol = 0.0 if op in ("gather_sub", "gather_lane", "idxadd") else 1e-6 * want.abs().max().item()
        if got.shape != (8, 128) or not err <= tol:
            fail(f"gatherbench {key}: checksum off by {err} (tol {tol})")
    print(f"gatherbench: {len(errs)} checksums against their plain versions ({len(gb.TAIL_CASES)} at "
          f"tail sizes), largest error {max(errs.values()):.3e} (gathers and idxadd exact; fma1, "
          f"splat2 1e-6 of scale) [{stamp}]")
    sass = gb.sass_i2f(built.path)
    print(f"gatherbench SASS (cuobjdump -sass {built.path.name}): I2F per kernel, in loops, loops: "
          + ", ".join(f"{k} {v['i2f']}/{v['in_loops']}/{v['loops']}" for k, v in sass.items()))
    if any(v["in_loops"] for v in sass.values()):
        fail(f"gatherbench: an I2F inside a loop: {sass}")
    clusters = {}
    for key, op, size, dtype in gb.cases():
        if op == "gather_sub":
            plan = gb.gather_sub_plan(*size, dtype)
            clusters[key] = {"clusters": plan.groups * plan.stripes // plan.cluster,
                             "cluster": plan.cluster, "max_active": gb.max_clusters(*size, dtype)}
    print("gather_sub clusters (needed / held at once): " + ", ".join(
        f"{k} {c['clusters']} of {c['cluster']} / {c['max_active']}" for k, c in clusters.items()))
    gb.launches = 0
    gb.launches_by_entry.clear()
    results = gb.sweep()
    torch.cuda.synchronize()
    launches, by_entry = gb.launches, dict(gb.launches_by_entry)
    want = collections.Counter()  # 20 timed calls and 2 warm-ups of each case and of its floor
    for _, op, _, _ in gb.cases():
        want[f"gb_{op}"] += 22
        want["gb_null"] += 22
    if by_entry != dict(want) or launches != sum(want.values()):
        fail(f"gatherbench's sweep launched {by_entry} ({launches} in all), not {dict(want)}")
    conflicts = gb.conflict_sweep()
    print("gather_lane 1040x256 under k-way bank conflicts, us per call (floor, wavefront figure): " + ", ".join(
        f"{w}-way {r['ms'] * 1e3:.4f} ({r['floor_ms'] * 1e3:.4f}, {r['smem_wavefront_ms'] * 1e3:.4f})"
        for w, r in conflicts.items()) + f" [{stamp}]")
    for key, r in results.items():
        wf = (f", shared-memory wavefronts {r['smem_wavefront_ms'] * 1e3:.4f} us "
              f"({r['wavefronts_per_read']:.3f} a read)" if "smem_wavefront_ms" in r else "")
        print(f"gatherbench {key}: {r['ms'] * 1e3:.4f} us per call ({r['us_per_op']:.4f} us per op and "
              f"iteration), bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}), launch floor "
              f"{r['floor_ms'] * 1e3:.4f} us{wf}, plain {r['plain_ms']:.4f} ms per call, one PyTorch "
              f"call per plane {r['library_us']:.2f} us [{stamp}]")
    return {"errs": errs, "results": results, "launches": launches, "by_entry": by_entry, "R": gb.R,
            "sass": sass, "clusters": clusters, "conflicts": conflicts}


class ConvFlags(TorchDispatchMode):
    """Records the (cuDNN, matmul) TF32 flags each time a convolution runs:
    an exported program has no ``nn.Conv2d`` to hook."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "convolution" in str(func):
            self.seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


def spec_label(spec) -> str:
    return (f"{spec['family']} {spec['height']}x{spec['width']} {spec['dtype_str']}"
            + (f" bs{spec['batch_size']}" if spec["batch_size"] != 1 else ""))


@functools.lru_cache(maxsize=None)
def seeded_model(family: str, dtype_str: str):
    """A matrix configuration's model with seed-0 weights, built once for
    all the deployment phases."""
    return build_codetr(FAMILIES[family](), dtype=DTYPES[dtype_str], device=DEVICE, seed=SEED)


def export_phase(tmp, image, stamp):
    """BASELINE configs[0] (R50 608x608 fp32) and [3] (Swin-L 1280x1920
    bf16): export, save, reload; the reloaded program against the
    in-process model on one served image (scores 2e-4, boxes 0.1 px; 12
    forward-kernel launches and 12 codetr:: nodes; fp32: TF32 off at every
    convolution).  Returns each reloaded program and its example inputs."""
    out = {}
    for i in EXPORTED:
        spec = MATRIX[i]
        dtype, h, w = DTYPES[spec["dtype_str"]], spec["height"], spec["width"]
        model = seeded_model(spec["family"], spec["dtype_str"])
        cfg = model.cfg
        t0 = time.perf_counter()
        fn, example = compile_forward(model, height=h, width=w, dtype=dtype)
        t_export = time.perf_counter() - t0
        path = os.path.join(tmp, f"configs{i}.codetr.pt2")
        t0 = time.perf_counter()
        save_executable(path, fn, example, meta={"config": spec["family"], "dtype": spec["dtype_str"],
                                                  "height": h, "width": w, "batch_size": 1,
                                                  "fused_preprocess": False})
        t_save = time.perf_counter() - t0
        del fn
        t0 = time.perf_counter()
        loaded = load_executable(path, device=DEVICE)
        t_load = time.perf_counter() - t0
        nodes = msda_nodes(loaded.exported)
        x, m = (t[None] for t in preprocess(image, h, w, cfg.preprocess, device=DEVICE)[:2])
        x = x.to(dtype)
        with torch.no_grad():
            want = model(x, m)
        msda.launches = msda.launches_qm = msda.launches_bwd = 0
        with ConvFlags() as flags:
            got = loaded(x, m)
        torch.cuda.synchronize()
        launches = (msda.launches, msda.launches_qm, msda.launches_bwd)
        drift = {"boxes": (got[0].float() - want[0].float()).abs().max().item(),
                 "scores": (got[1].float() - want[1].float()).abs().max().item(),
                 "labels_differ": int((got[2] != want[2]).sum().item())}
        tf32 = sorted(set(flags.seen))
        print(f"export {spec_label(spec)}: export {t_export:.1f} s, save {t_save:.1f} s "
              f"({os.path.getsize(path) / 1e6:.1f} MB), load {t_load:.1f} s; codetr:: nodes {nodes}; "
              f"reloaded forward: kernel launches (forward, q-minor, backward) {launches}, drift vs the "
              f"in-process model: boxes {drift['boxes']:.3e} px, scores {drift['scores']:.3e}, labels "
              f"differing {drift['labels_differ']}; (cuDNN, matmul) TF32 flags at its {len(flags.seen)} "
              f"convolutions {tf32} [{stamp}]")
        if nodes != {"codetr.msda_packed.default": 6, "codetr.msda_reference.default": 6}:
            fail(f"the exported {spec_label(spec)} program holds {nodes}, not 6 + 6 codetr:: nodes")
        if launches != (12, 0, 0):
            fail(f"the reloaded {spec_label(spec)} program launched {launches}, not (12, 0, 0)")
        if not (drift["scores"] <= 2e-4 and drift["boxes"] <= 0.1):
            fail(f"the reloaded {spec_label(spec)} program drifts {drift} (scores 2e-4, boxes 0.1 px)")
        if dtype == torch.float32 and tf32 != [(False, False)]:
            fail(f"the reloaded fp32 program ran convolutions under TF32 flags {tf32}")
        out[i] = {"program": (loaded, example), "launches": launches[0], "drift": drift,
                  "export_s": t_export, "save_s": t_save, "load_s": t_load, "nodes": nodes}
        del want, got
        torch.cuda.empty_cache()
    return out


def matrix_phase(exported, iterations, stamp):
    """``codetr_torch.bench``'s five configurations: CUDA-graph replays of
    the exported program beside its eager calls, ms per image; configs[0]
    and [3] time the reloaded programs of ``export_phase``."""
    lines = []
    for i, spec in enumerate(MATRIX):
        if i in exported:
            program = exported[i]["program"]
        else:
            program = compile_forward(seeded_model(spec["family"], spec["dtype_str"]), height=spec["height"],
                                      width=spec["width"], batch_size=spec["batch_size"],
                                      dtype=DTYPES[spec["dtype_str"]])
        r = measure_config(**spec, iterations=iterations, program=program, device=DEVICE)
        r["reloaded"] = i in exported
        del program
        print("matrix " + json.dumps(r), flush=True)
        if r["msda_launches_per_call"] != 12:
            fail(f"{spec_label(spec)}: {r['msda_launches_per_call']} forward-kernel launches a call, not 12")
        lines.append(r)
        torch.cuda.empty_cache()
    return lines


def fused_phase(tmp, images, stamp):
    """Swin-L 768x1152 bf16 at batch 4 through the reloaded fused program
    (uint8 canvas in, preprocessing inside) on 5 images (the second batch
    padded), against the host-preprocess eager Inferencer at batch 4:
    scores 2e-4, boxes 0.1 px."""
    spec = MATRIX[4]
    dtype, h, w, bs = DTYPES[spec["dtype_str"]], spec["height"], spec["width"], spec["batch_size"]
    model = seeded_model(spec["family"], spec["dtype_str"])
    cfg = model.cfg
    fn, example = compile_forward(model, height=h, width=w, batch_size=bs, dtype=dtype,
                                  fuse_preprocess=True, preprocess_cfg=cfg.preprocess)
    path = os.path.join(tmp, "fused.codetr.pt2")
    save_executable(path, fn, example, meta={"config": "swin-l", "dtype": spec["dtype_str"], "height": h,
                                              "width": w, "batch_size": bs, "fused_preprocess": True})
    del fn
    loaded = load_executable(path, device=DEVICE)
    fused = Inferencer(model, height=h, width=w, batch_size=bs, compiled_fn=loaded, input_dtype=dtype,
                       device_preprocess=True, device=DEVICE)
    host = Inferencer(model, height=h, width=w, batch_size=bs, device=DEVICE)
    fused(images[:1])  # warm-up
    msda.launches = msda.launches_qm = msda.launches_bwd = 0
    got, t_fused = timed(lambda: fused(images))
    launches = (msda.launches, msda.launches_qm, msda.launches_bwd)
    want, t_host = timed(lambda: host(images))
    check_detections(got, len(images), cfg.head.max_per_img)
    err = {"scores": 0.0, "boxes": 0.0, "keep_differ": 0}
    for g, wnt in zip(got, want):
        err["keep_differ"] += int((g.keep != wnt.keep).sum())
        k = g.keep & wnt.keep
        err["scores"] = max(err["scores"], float(np.abs(g.scores[k] - wnt.scores[k]).max()))
        err["boxes"] = max(err["boxes"], float(np.abs(g.boxes[k] - wnt.boxes[k]).max()))
    print(f"fused Inferencer swin-l {h}x{w} bf16 batch {bs}, reloaded fused program, {len(images)} images: "
          f"{t_fused:.1f} ms (host-preprocess eager batch {bs}: {t_host:.1f} ms), launches (forward, "
          f"q-minor, backward) {launches}; against the eager Inferencer: scores {err['scores']:.3e}, boxes "
          f"{err['boxes']:.3e} px, keep masks differing {err['keep_differ']} [{stamp}]")
    batches = -(-len(images) // bs)
    if launches != (12 * batches, 0, 0):
        fail(f"the fused Inferencer launched {launches}, not ({12 * batches}, 0, 0)")
    if err["keep_differ"] or not (err["scores"] <= 2e-4 and err["boxes"] <= 0.1):
        fail(f"the fused Inferencer's detections differ from the eager one's: {err}")
    del loaded, fused, host
    torch.cuda.empty_cache()
    return {"launches": launches[0], "err": err, "ms": t_fused, "host_ms": t_host}


def trace_pieces(events, kernels) -> dict:
    """Each annotated range of a trace (preprocess, forward, postprocess):
    its host ms, the share of it in which a kernel ran, and, by correlation
    id, the kernels that its launch calls started wherever those ran (a CUDA
    graph's kernels carry its launch's id and run after its host range):
    their count, device span and busy time, and the range's host time in
    each runtime call."""
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    started = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "kernel" and "correlation" in e.get("args", {}):
            started[e["args"]["correlation"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    pieces = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in ("preprocess", "forward", "postprocess"):
            a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            inside = [(max(ka, a), min(kb, b)) for ka, kb, _ in kernels if kb > a and ka < b]
            own = [c for c in calls if a <= float(c["ts"]) <= b]
            spans = [k for c in own for k in started.get(c.get("args", {}).get("correlation"), [])]
            span = (max(kb for _, kb in spans) - min(ka for ka, _ in spans)) if spans else 0.0
            pieces[e["name"]] = {
                "ms": (b - a) / 1e3, "kernel_share": union_us(inside) / max(b - a, 1e-9),
                "kernels_started": len(spans), "kernel_ms": union_us(spans) / 1e3, "device_span_ms": span / 1e3,
                "launch_calls": dict(collections.Counter(c["name"] for c in own
                                                         if started.get(c.get("args", {}).get("correlation")))),
                "host_call_ms": {n: sum(float(c["dur"]) for c in own if c["name"] == n) / 1e3
                                 for n in sorted({c["name"] for c in own})},
            }
    return pieces


def trace_phase(tmp, image, stamp):
    """One traced image through the Swin-L 768x1152 fp32 Inferencer (after
    a warm-up image, which captured its postprocess): the share of the
    traced window in which a kernel ran, each annotated piece's, the
    kernels that the postprocess range's launch calls started (by
    correlation id: a CUDA graph runs after its host range) and the device
    time they spanned, and the five kernels with the most time."""
    cfg = co_dino_swin_l()
    model = build_codetr(cfg, dtype=torch.float32, device=DEVICE, seed=SEED)
    inf = Inferencer(model, height=HEIGHT, width=WIDTH, device=DEVICE)
    inf([image])
    torch.cuda.synchronize()
    logdir = os.path.join(tmp, "trace")
    with trace(logdir):
        inf([image])
        torch.cuda.synchronize()
    with open(os.path.join(logdir, "trace.json")) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    kernels = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
               if e.get("cat") == "kernel"]
    if not kernels:
        fail("the trace holds no kernel event")
    t0 = min(float(e["ts"]) for e in events)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in events)
    busy = union_us([(a, b) for a, b, _ in kernels])
    pieces = trace_pieces(events, kernels)
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for a, b, name in kernels:
        by_name[name][0] += b - a
        by_name[name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    share = busy / (t1 - t0)
    print(f"trace Swin-L {HEIGHT}x{WIDTH} fp32, one served image: window {(t1 - t0) / 1e3:.2f} ms, a kernel "
          f"running {busy / 1e3:.2f} ms ({share:.4f}; idle {1 - share:.4f}), {len(kernels)} kernel launches; "
          + ", ".join(f"{k} {v['ms']:.2f} ms (kernel share {v['kernel_share']:.4f})" for k, v in pieces.items())
          + f" [{stamp}]")
    post = pieces.get("postprocess")
    if post:
        print(f"trace postprocess ({cfg.head.nms_type}, the captured program): host range {post['ms']:.3f} ms; "
              f"its launch calls {post['launch_calls']} started {post['kernels_started']} kernels"
              + (f", which ran over {post['device_span_ms']:.3f} ms of the device, a kernel running "
                 f"{post['kernel_ms']:.3f} ms of it ({post['kernel_ms'] / max(post['device_span_ms'], 1e-9):.4f})"
                 if post["kernels_started"] else
                 " (no kernel event carries their correlation ids: the profiler shows the graph as one launch)")
              + "; host time in its runtime calls: "
              + ", ".join(f"{n} {ms:.3f} ms" for n, ms in post["host_call_ms"].items()) + f" [{stamp}]")
    print("trace: the five kernels with the most time: " + "; ".join(
        f"{name[:90]} {t / 1e3:.3f} ms in {n}" for name, (t, n) in top))
    del model, inf
    torch.cuda.empty_cache()
    return {"window_ms": (t1 - t0) / 1e3, "kernel_ms": busy / 1e3, "kernel_share": share,
            "pieces": pieces, "top": [(name, t / 1e3, n) for name, (t, n) in top]}


# ten COCO-like image sizes: at batch 4 the last batch holds two images
EVAL_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500), (612, 612), (333, 500), (640, 427),
              (500, 375), (360, 480), (640, 640))
EVAL_BATCH = 4  # the JAX eval_coco.py's default
THROUGHPUT_IMAGES = 100  # pass 3: 25 full batches of EVAL_BATCH
THROUGHPUT_RUNS = 2  # pass 3's readings in one call
COCO_GTS_PER_IMAGE = 36781 / 5000  # COCO val2017: instances over images
# COCO 2017's 80 category ids, of 1..90: the annotations' ids, densified to the model's labels
COCO_CATEGORY_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]
BOX_TOL, SCORE_TOL = 0.1, 2e-4  # the ladder: boxes px, scores


def eval_ground_truth(preds):
    """COCO annotations that the detections ``preds`` score exactly against:
    every detection scoring above a cut (non-crowd, ``bbox`` xywh, ``area``
    w * h), the cut at least each image's 101st score (at most 100 gts an
    image, so maxDets truncates none) and each zero-area box's score (a box
    with no area overlaps nothing).  What stays below the cut ranks below
    every gt's detection, so a second identical pass scores mAP = AR_100 = 1."""
    cut = -np.inf
    for p in preds:
        scores = np.sort(p["scores"])[::-1]
        if len(scores) > 100:
            cut = max(cut, float(scores[100]))
        b = p["boxes"]
        flat = (b[:, 2] <= b[:, 0]) | (b[:, 3] <= b[:, 1])
        if flat.any():
            cut = max(cut, float(p["scores"][flat].max()))
    anns = []
    for image_id, p in enumerate(preds, 1):
        for b, score, label in zip(p["boxes"].astype(np.float64), p["scores"], p["labels"]):
            if score > cut:
                w, h = b[2] - b[0], b[3] - b[1]
                anns.append({"id": len(anns) + 1, "image_id": image_id, "iscrowd": 0, "area": w * h,
                             "category_id": COCO_CATEGORY_IDS[int(label)], "bbox": [b[0], b[1], w, h]})
    return anns, cut


def coco_like_ground_truth(sizes, rng):
    """Synthetic annotations at COCO val2017's density: a Poisson count of
    gts an image (mean 7.36), categories uniform over COCO's 80 ids, boxes
    inside the image with sides log-uniform from 2% to 60% of the image's
    geometric mean side (small, medium and large areas all occur)."""
    anns = []
    for image_id, (h, w) in enumerate(sizes, 1):
        for _ in range(rng.poisson(COCO_GTS_PER_IMAGE)):
            side = np.sqrt(h * w) * np.exp(rng.uniform(np.log(0.02), np.log(0.6)))
            aspect = np.exp(rng.uniform(-0.7, 0.7))
            bw, bh = min(side * aspect, w - 1.0), min(side / aspect, h - 1.0)
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0, h - bh)
            anns.append({"id": len(anns) + 1, "image_id": image_id, "iscrowd": 0, "area": bw * bh,
                         "category_id": int(rng.choice(COCO_CATEGORY_IDS)), "bbox": [x0, y0, bw, bh]})
    return anns


def write_instances(path, names, sizes, anns):
    from codetr_torch.utils.coco import COCO_CLASSES

    with open(path, "w") as f:
        json.dump({"images": [{"id": i + 1, "file_name": n, "height": h, "width": w}
                              for i, (n, (h, w)) in enumerate(zip(names, sizes))],
                   "annotations": anns,
                   "categories": [{"id": c, "name": COCO_CLASSES[i]} for i, c in enumerate(COCO_CATEGORY_IDS)]},
                  f)
    return path


def unmatched_detections(got, want, score_tol=SCORE_TOL, box_tol=BOX_TOL):
    """Greedy set-wise match of two images' detections: each of ``want``'s
    (highest score first) to an unused one of ``got`` with its label, its
    score within ``score_tol`` and the nearest box -> (unmatched count, the
    largest box difference among the matched, px)."""
    used = np.zeros(len(got["scores"]), bool)
    unmatched, worst = 0, 0.0
    for j in np.argsort(-want["scores"], kind="stable"):
        cand = np.nonzero((got["labels"] == want["labels"][j]) & ~used
                          & (np.abs(got["scores"] - want["scores"][j]) <= score_tol))[0]
        d = np.abs(got["boxes"][cand] - want["boxes"][j]).max(axis=1) if len(cand) else np.array([np.inf])
        if d.min() > box_tol:
            unmatched += 1
            continue
        used[cand[np.argmin(d)]] = True
        worst = max(worst, float(d.min()))
    return unmatched, worst


def host_rescaled_batch(model, inf, paths):
    """One batch's detections by the JAX script's route after the forward:
    the card's raw outputs moved to the host, postprocessed there (the plain
    NMS, boxes left in canvas pixels), and rescaled in float64 by each
    image's keep-ratio scale factor, computed here from its size
    (``eval_coco.py``'s ``b / [sx, sy, sx, sy]``)."""
    from codetr_torch.ops.nms import postprocess_detections
    from codetr_torch.utils.image_io import read_image

    images = [read_image(p) for p in paths]
    head = model.cfg.head
    with torch.inference_mode():
        args, _ = inf._inputs(images)
        raw = [t.cpu() for t in model(*args)]
    b, s, l, keep = (t.numpy() for t in postprocess_detections(
        *raw, score_threshold=inf.score_threshold, iou_threshold=inf.iou_threshold, scale_factor=None,
        nms_type=inf.nms_type, nms_sigma=head.nms_sigma, nms_min_score=head.nms_min_score))
    out = []
    for j, im in enumerate(images):
        oh, ow = im.shape[:2]
        scale = min(WIDTH / ow, HEIGHT / oh)
        sx, sy = int(ow * scale + 0.5) / ow, int(oh * scale + 0.5) / oh
        k = keep[j]
        out.append({"boxes": b[j][k].astype(np.float64) / np.array([sx, sy, sx, sy]),
                    "scores": s[j][k], "labels": l[j][k]})
    return out


def eval_phase(tmp, stamp):
    """COCO evaluation (``codetr_torch.eval_coco``) with the seed-0 Swin-L
    weights passed as a ``.pth`` whose ``meta`` holds numpy values, on
    synthetic ``.npy`` images and COCO instances files with COCO's 80
    category ids.  Pass 1: ``predict`` at fp32 with NMS, batch 4, over ten
    images (the last batch short); its first batch held set-wise against
    ``host_rescaled_batch`` (same label, scores 2e-4, boxes 0.1 px), then
    its detections made the ground truth (``eval_ground_truth``).  Pass 2:
    ``eval_coco.main`` at fp32 with NMS against it must score mAP = AR_100
    = 1 (to 1e-9): the detections are deterministic and the evaluator's
    plumbing (files, category ids, image order) loses none.  Pass 3, run
    THROUGHPUT_RUNS times: the JAX script's defaults (bf16, soft-NMS, batch
    4) over 100 images against ground truth at COCO val2017's density
    (``coco_like_ground_truth``), its metrics printed ungated (random
    weights), its images per second, seconds per part and peak memory.
    Each ``main`` call's batches launch the forward kernel 12 times each
    (the launch counts set to 0 just before it and read just after)."""
    from codetr_torch import eval_coco
    from codetr_torch.utils.coco import COCO_CLASSES

    root = os.path.join(tmp, "coco")
    os.makedirs(root)
    rng = np.random.default_rng(SEED + 11)
    sizes = [EVAL_SIZES[i % len(EVAL_SIZES)] for i in range(THROUGHPUT_IMAGES)]
    names = [f"{i:012d}.npy" for i in range(THROUGHPUT_IMAGES)]
    for name, (h, w) in zip(names, sizes):
        np.save(os.path.join(root, name), rng.integers(0, 256, (h, w, 3), np.uint8))
    n_exact = len(EVAL_SIZES)  # passes 1 and 2
    weights = os.path.join(root, "swin_l_seed0.pth")
    model = build_codetr(CONFIG(), device="cpu", seed=SEED)
    torch.save({"state_dict": model.state_dict(),
                "meta": {"seed": np.int64(SEED), "iters": np.arange(3),
                         "dataset_meta": {"CLASSES": list(COCO_CLASSES)}}}, weights)
    del model
    per_batch = launches_per_forward(CONFIG())  # 12 for Swin-L: 6 encoder + 6 decoder layers

    # pass 1: the detections that become the ground truth, the first batch
    # held against the host route
    paths = [os.path.join(root, n) for n in names[:n_exact]]
    model = build_codetr(CONFIG(), weights, dtype=torch.float32, device=DEVICE)
    inf = Inferencer(model, height=HEIGHT, width=WIDTH, batch_size=EVAL_BATCH, nms_type="nms", device=DEVICE)
    preds = eval_coco.predict(inf, paths)
    host = host_rescaled_batch(model, inf, paths[:EVAL_BATCH])
    del model, inf
    torch.cuda.empty_cache()
    if len(preds) != n_exact:
        fail(f"predict gave {len(preds)} results for {n_exact} images")
    for p in preds:
        n = len(p["scores"])
        if not (0 < n <= CONFIG().head.max_per_img and p["boxes"].shape == (n, 4) and p["labels"].shape == (n,)):
            fail(f"predict: bad detections {p['boxes'].shape} {p['scores'].shape} {p['labels'].shape}")
        if not (np.isfinite(p["boxes"]).all() and np.isfinite(p["scores"]).all()):
            fail("predict: non-finite detections")
    worst = 0.0
    for j, (got, want) in enumerate(zip(preds, host)):
        missed, w = unmatched_detections(got, want)
        worst = max(worst, w)
        if len(got["scores"]) != len(want["scores"]) or missed:
            fail(f"eval_coco pass 1 image {j}: {len(got['scores'])} detections on the card, "
                 f"{len(want['scores'])} by the host route, {missed} of the latter unmatched")
    print(f"eval_coco pass 1, first batch: {sum(len(p['scores']) for p in host)} detections equal, set-wise, "
          f"to the raw outputs postprocessed on the CPU and rescaled on the host in float64 (largest box "
          f"difference {worst:.3e} px; tolerance {BOX_TOL} px, scores {SCORE_TOL}) [{stamp}]")
    anns, cut = eval_ground_truth(preds)
    exact_ann = write_instances(os.path.join(root, "instances_exact.json"), names[:n_exact], sizes, anns)
    print(f"eval_coco pass 1 (predict, fp32, nms, batch {EVAL_BATCH}): {sum(len(p['scores']) for p in preds)} "
          f"detections over {n_exact} images; {len(anns)} of them, scoring above {cut:.6f}, are the "
          f"ground truth ({len({a['category_id'] for a in anns})} categories) [{stamp}]")
    coco_anns = coco_like_ground_truth(sizes, rng)
    coco_ann = write_instances(os.path.join(root, "instances_coco_like.json"), names, sizes, coco_anns)
    print(f"eval_coco pass 3's ground truth: {len(coco_anns)} gts over {THROUGHPUT_IMAGES} images "
          f"({len({a['category_id'] for a in coco_anns})} categories), at COCO val2017's density")

    common = ["--img-dir", root, "--weights", weights]
    runs = [("pass 2", ["--ann", exact_ann, "--dtype", "float32", "--nms-type", "nms"], n_exact)]
    runs += [(f"pass 3 ({r + 1})", ["--ann", coco_ann], THROUGHPUT_IMAGES) for r in range(THROUGHPUT_RUNS)]
    results = {}
    for label, extra, n_images in runs:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        batches = -(-n_images // EVAL_BATCH)
        msda.launches = msda.launches_qm = msda.launches_bwd = 0
        t0 = time.perf_counter()
        metrics = eval_coco.main(common + extra, timings)
        wall = time.perf_counter() - t0
        launches = (msda.launches, msda.launches_qm, msda.launches_bwd)
        results[label] = {"metrics": metrics, "timings": timings, "wall_s": wall, "launches": launches,
                          "images": n_images, "batches": batches,
                          "peak_bytes": torch.cuda.max_memory_allocated()}
        if launches != (per_batch * batches, 0, 0):
            fail(f"eval_coco {label} launched (forward, q-minor, backward) kernels {launches}, not "
                 f"({per_batch * batches}, 0, 0): {per_batch} a batch over {batches} batches")
    m2 = results["pass 2"]["metrics"]
    print(f"eval_coco pass 2 (fp32, nms, against pass 1's detections): mAP {m2['mAP']:.12f}, AR_100 "
          f"{m2['AR_100']:.12f} (both must be 1 to 1e-9) [{stamp}]")
    if abs(m2["mAP"] - 1.0) > 1e-9 or abs(m2["AR_100"] - 1.0) > 1e-9:
        fail(f"eval_coco pass 2 scored {m2}, not mAP = AR_100 = 1")
    for r in range(THROUGHPUT_RUNS):
        r3 = results[f"pass 3 ({r + 1})"]
        t, n, batches = r3["timings"], r3["images"], r3["batches"]
        loop_s = t["read_s"] + t["serve_s"] + t["evaluate_s"]
        print(f"eval_coco pass 3, run {r + 1} of {THROUGHPUT_RUNS} (the JAX script's defaults: swin-l "
              f"{HEIGHT}x{WIDTH} bf16, soft-NMS, batch {EVAL_BATCH}; {n} images, {batches} batches): "
              f"metrics (random weights, ungated) {json.dumps(r3['metrics'])}; {n / loop_s:.3f} images/s "
              f"end to end (read + serve + evaluate; serving alone {n / t['serve_s']:.3f}), seconds read "
              f"{t['read_s']:.4f}, serve (forward + postprocess) {t['serve_s']:.4f}, evaluate_detections "
              f"{t['evaluate_s']:.4f}; main() {r3['wall_s']:.2f} s with the model's build from the .pth; "
              f"peak memory allocated {r3['peak_bytes'] / 2**30:.3f} GiB; forward-kernel launches "
              f"{r3['launches'][0]} ({r3['launches'][0] // batches} a batch) [{stamp}]")
    return results


REHEARSAL_HW = (608, 608)  # the JAX tools/rehearsal.py's default size
REHEARSAL_SCALES = (1.0, 2.0)  # the offset drift of the rehearsal's file, and twice it


def rehearsal_taps(model, cal_x):
    """The staged share of each encoder layer's taps (``share_summary``)
    and the first layer's taps, on the rehearsal's calibration batch."""
    with rehearsal.capture_encoder_taps(keep=1) as calls:
        rehearsal.detections(model, list(cal_x), torch.device(DEVICE))
    return rehearsal.share_summary(calls), calls[0]["taps"]


def rounding_controls(reader, detail):
    """How far bf16 rounding alone moves this checkpoint's detections: the
    fp32 reader (the writer's function) in fp32 compute on the images
    rounded to bf16, then with its weights rounded to bf16 on the images as
    they are, each scored as the rehearsal scores its reader (box IoU
    p50 / min, mAP against the writer's ground truth).  Leaves the reader's
    weights rounded."""
    from codetr_torch.utils.coco_eval import evaluate_detections

    def score(dets):
        preds = [{"boxes": b, "scores": s, "labels": l} for b, s, l, _ in dets]
        ious = rehearsal.box_match_ious(detail["ground_truth"], preds)
        return {"box_match_iou_p50": float(np.median(ious)), "box_match_iou_min": float(ious.min()),
                "mAP": evaluate_detections(preds, detail["ground_truth"], detail["cfg"].head.num_classes)["mAP"]}

    dev = torch.device(DEVICE)
    rounded = [torch.from_numpy(im).bfloat16().float().numpy() for im in detail["images"]]
    out = {"inputs": score(rehearsal.detections(reader, rounded, dev))}
    with torch.no_grad():
        for t in reader.state_dict().values():
            if t.is_floating_point():
                t.copy_(t.bfloat16().float())
    out["weights"] = score(rehearsal.detections(reader, detail["images"], dev))
    return out


def rehearsal_phase(tmp, seed0, stamp):
    """Checkpoint day (``codetr_torch.tools.rehearsal`` at the JAX tool's
    defaults): the Swin-L writer (seed 0, fp32, on the host) with offsets
    drifted at scale 1.0, written as a ``.pth`` with numpy values in its
    meta, read by a bf16 reader on the card (another init seed) and scored
    against the writer's top-20: 12 forward-kernel launches a forward (the
    launch counts set to 0 just before the reader's forwards and read just
    after) and finite detections of the right shapes are gated; ``pass``
    (box IoU p50 >= 0.9) is printed beside ``rounding_controls`` (the
    writer's function in fp32 on bf16-rounded inputs, then weights), the
    staged share per layer beside seed 0's (``encoder_stage``), the
    replays' p50 / p95 / min.  Then an fp32 reader of the same file on the
    same images against the writer: on the ladder (scores 2e-4, index by
    index and set-wise with boxes 0.1 px; at most 1% unmatched) where both
    decoders started from the same proposals at the same ranks, else at
    ``compare_models``' tolerance (a near-tied proposal that swaps ranks
    gives its query another content embedding), with its
    ``ap_vs_writer``.  Then K1 on the first encoder layer's own taps of
    the calibration batch, fp32 models: seed 0's (no drift), the file's
    (scale 1.0) and scale 2.0's, each held against the plain version
    (``check_kernel``), timed in fp32 and bf16 beside its plain version and
    bound, with each model's staged share (reported, not gated)."""
    from codetr_torch.utils.coco_eval import evaluate_detections

    h, w = REHEARSAL_HW
    t0 = time.perf_counter()
    record, detail = rehearsal.rehearse(rehearsal.parse_args(
        ["--height", str(h), "--width", str(w), "--out", os.path.join(tmp, "rehearsal.pth")]))
    torch.cuda.empty_cache()
    cfg, n_img = detail["cfg"], record["images"]
    print(f"rehearsal record: {json.dumps(record)}")
    per_forward = launches_per_forward(cfg)
    la, lat, share = record["msda_launches"], record["latency_ms"], record["staged_share"]
    print(f"rehearsal Swin-L {h}x{w} {record['dtype']} reader of a seed-{SEED} fp32 writer's .pth (offset scale "
          f"{record['offset_scale']}): pass {record['pass']}, box IoU p50 {record['box_match_iou_p50']:.6f}, min "
          f"{record['box_match_iou_min']:.6f}, mAP {record['ap_vs_writer']['mAP']:.4f}, top-k proposals shared "
          f"with the writer {[round(x, 6) for x in record['proposals_shared']]}, at the same rank "
          f"{[round(x, 6) for x in record['proposals_in_place']]}; forward launches "
          f"{la['forward']} over {n_img} forwards (q-minor {la['q_minor']}, backward {la['backward']}); the "
          f"exported forward replayed p50 {lat['p50']:.3f} ms, p95 {lat['p95']:.3f}, min {lat['min']:.3f} "
          f"[{stamp}]")
    print(f"rehearsal staged share ({record['dtype']} plan, {h}x{w}, the calibration batch) per layer "
          f"{[round(x, 6) for x in share['per_layer']]}, overall {share['overall']:.6f}; seed {SEED}'s "
          f"(encoder_stage, fp32 plan, {HEIGHT}x{WIDTH}, an image) "
          f"{[round(x, 6) for x in seed0['staged_share_per_layer']]}, overall {seed0['staged_share']:.6f} [{stamp}]")
    if (la["forward"], la["q_minor"], la["backward"]) != (per_forward * n_img, 0, 0):
        fail(f"the rehearsal's bf16 reader launched {la}, not {per_forward} forward kernels a forward")
    n_det = cfg.head.max_per_img
    for b, s, _, _ in detail["reader"]:
        if b.shape != (n_det, 4) or s.shape != (n_det,) or not (np.isfinite(b).all() and np.isfinite(s).all()):
            fail(f"the rehearsal's reader gave boxes {b.shape}, scores {s.shape} or non-finite values")

    # the fp32 reader of the same file, on the same images, against the writer
    reader = build_codetr(cfg, detail["pth"], dtype=torch.float32, device=DEVICE, seed=detail["reader_seed"])
    msda.launches = 0
    dets = rehearsal.detections(reader, detail["images"], torch.device(DEVICE))
    launches = msda.launches
    # the ladder where both devices took the same top-900 proposals at the
    # same ranks; where near-tied ones differ or swap ranks, compare_models'
    # tolerance for full-width models
    ladder = []
    for (gb, gs, gl, _), (wb, ws, wl, _), shared, in_place in zip(
            dets, detail["writer"], rehearsal.proposals_shared(dets, detail["writer"]),
            rehearsal.proposals_in_place(dets, detail["writer"])):
        score_tol, box_tol = (SCORE_TOL, BOX_TOL) if in_place == 1 else (MODEL_SCORE_TOL, MODEL_BOX_TOL)
        unmatched, worst = unmatched_detections({"boxes": gb, "scores": gs, "labels": gl},
                                                {"boxes": wb, "scores": ws, "labels": wl}, score_tol, box_tol)
        strict = unmatched_detections({"boxes": gb, "scores": gs, "labels": gl},
                                      {"boxes": wb, "scores": ws, "labels": wl})[0]
        ladder.append({"proposals_shared": shared, "proposals_in_place": in_place,
                       "score_err": float(np.abs(gs - ws).max()), "score_tol": score_tol, "box_tol": box_tol,
                       "unmatched": unmatched, "worst_px": worst,
                       "unmatched_on_the_ladder": strict, "n": len(ws)})
    ap32 = evaluate_detections([{"boxes": b, "scores": s, "labels": l} for b, s, l, _ in dets],
                               detail["ground_truth"], cfg.head.num_classes)
    for i, r in enumerate(ladder):
        print(f"rehearsal fp32 reader on the card against the fp32 writer on the host, image {i}: top-k proposals "
              f"shared {r['proposals_shared']:.6f}, at the same rank {r['proposals_in_place']:.6f}; score error "
              f"{r['score_err']:.3e} (tol {r['score_tol']}), "
              f"unmatched {r['unmatched']} of {r['n']} at {r['box_tol']} px (tol {max(1, r['n'] // 100)}), largest "
              f"matched box difference {r['worst_px']:.6f} px; on the ladder (scores {SCORE_TOL}, boxes {BOX_TOL} "
              f"px) {r['unmatched_on_the_ladder']} unmatched [{stamp}]")
    print(f"rehearsal fp32 reader: ap_vs_writer {json.dumps(ap32)}; forward launches {launches} [{stamp}]")
    if any(r["score_err"] > r["score_tol"] or r["unmatched"] > max(1, r["n"] // 100) for r in ladder) \
            or launches != per_forward * n_img:
        fail("the fp32 reader on the card disagrees with the writer")

    # K1 on the first encoder layer's own taps: seed 0's, the file's, scale 2.0's
    base = build_codetr(cfg, device="cpu", seed=SEED)
    sd0 = {k: v.numpy().copy() for k, v in base.state_dict().items()}
    base = base.to(DEVICE)
    runs = {"seed 0": rehearsal_taps(base, detail["cal_x"]), f"scale {REHEARSAL_SCALES[0]}":
            rehearsal_taps(reader, detail["cal_x"])}
    controls = rounding_controls(reader, detail)
    del reader
    print(f"rehearsal controls, the fp32 reader (the writer's function: the ladder above) in fp32 compute against "
          f"the writer's ground truth, with only its inputs rounded to bf16: {json.dumps(controls['inputs'])}; "
          f"with only its weights rounded to bf16: {json.dumps(controls['weights'])}; the bf16 reader: box IoU "
          f"p50 {record['box_match_iou_p50']:.6f}, min {record['box_match_iou_min']:.6f}, mAP "
          f"{record['ap_vs_writer']['mAP']:.6f}; pass (box IoU p50 >= {rehearsal.PASS_IOU}) reported, not gated "
          f"[{stamp}]")
    for scale in REHEARSAL_SCALES[1:]:
        sd = rehearsal.perturb_offsets(dict(sd0), scale, SEED)
        base.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        runs[f"scale {scale}"] = rehearsal_taps(base, detail["cal_x"])
    del base, sd0
    k1 = {}
    for name, (shares, (value, shapes, cpk, P)) in runs.items():
        K, heads = value.shape[1], value.shape[2]
        errs = check_kernel(
            f"K1 on the rehearsal's {name} taps {h}x{w} (first encoder layer, Q={K})", value,
            lambda v: msda.msda_grid_packed(v, shapes, cpk, P),
            lambda v: msda.msda_grid_packed_plain(v, shapes, cpk, P), stamp)
        x, y, wt = msda._unpack(cpk, heads, len(shapes), P)
        b_ms, b_by, nbytes, flops = bound_ms(value, shapes, torch.stack([x, y], -1), wt, torch.float32)
        vb = value.to(torch.bfloat16)
        r = k1[name] = {
            "ms": cuda_ms(functools.partial(msda.msda_grid_packed, value, shapes, cpk, P), 20),
            "ms_bf16": cuda_ms(functools.partial(msda.msda_grid_packed, vb, shapes, cpk, P), 20),
            "plain_ms": cuda_ms(functools.partial(msda.msda_grid_packed_plain, value, shapes, cpk, P), 3),
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": errs["max_abs_err_fp32"],
            "max_abs_err_bf16": errs["max_abs_err_bf16"], "staged_share_first_layer": shares["per_layer"][0],
            "staged_share_per_layer": shares["per_layer"], "staged_share": shares["overall"],
        }
        print(f"K1 on the rehearsal's {name} taps {h}x{w}: {r['ms']:.4f} ms/call fp32, {r['ms_bf16']:.4f} bf16, "
              f"plain {r['plain_ms']:.4f}, bound {b_ms:.4f} ms ({b_by}); staged share (fp32 plan) first layer "
              f"{r['staged_share_first_layer']:.6f}, per layer {[round(x, 6) for x in shares['per_layer']]}, "
              f"overall {r['staged_share']:.6f} [{stamp}]")
        del value, cpk, vb
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    print(f"rehearsal phase {wall:.1f} s wall (write {record['synthesize_s']:.1f}, convert "
          f"{record['convert_s']:.1f}, share {record['calibrate_s']:.1f}, serve {record['serve_s']:.1f}, export "
          f"and timing {record['time_s']:.1f}) [{stamp}]")
    return {"record": record, "fp32_ladder": ladder, "fp32_ap": ap32, "fp32_launches": launches, "k1": k1,
            "controls": controls}


ATTR_HW = (1280, 1920)  # matrix [3]'s shape (codetr_torch/bench.py), the config whose miss PERF.md §7 asks about
ATTR_CONFIG = "swin-l"
ATTR_ITERS, ATTR_TRIALS = 3, 3  # cut from the JAX tools' 5-20 and 5-6 to keep the phase short; never the shapes
ATTR_SUM_TOL = 0.15  # features + detect against full (the JAX tools/attr.py's derived record)


def attribution_phase(tmp, stamp):
    """``codetr_torch.tools.attr``'s four suites at 1280x1920 bf16 on one
    seed-0 Swin-L model: ``model`` and ``encoder`` with ``--verify`` (K1's
    encoder and decoder entries against the plain version on the modules'
    own inputs) and ``--trace``, ``swin`` over stages 0-3, ``mem``.  Fails
    on a kernel check, on a stage with no time or floor, on ``features +
    detect`` more than 15% off ``full``, and on a traced stage whose trace
    lacks the kernel it runs."""
    h, w = ATTR_HW
    t0 = time.perf_counter()
    model = build_codetr(CONFIG(), dtype=torch.bfloat16, device=DEVICE, seed=SEED)
    common = ["--device", DEVICE, "--config", ATTR_CONFIG, "--dtype", "bfloat16",
              "--iters", str(ATTR_ITERS), "--trials", str(ATTR_TRIALS)]
    runs = {
        "model": ["model", str(h), str(w), "--verify", "--trace", os.path.join(tmp, "model")],
        "swin": ["swin", "--height", str(h), "--width", str(w), "--stages", "0", "1", "2", "3"],
        "encoder": ["encoder", str(h), str(w), "--verify", "--trace", os.path.join(tmp, "encoder")],
        "mem": ["mem", "--height", str(h), "--width", str(w)],
    }
    results, wall = {}, {}
    for suite, argv in runs.items():
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # the tool's JSON lines; summarised below
            results[suite] = r = attr.main(argv + common, model=None if suite == "mem" else model)
        wall[suite] = time.perf_counter() - t1
        c = r["summary"]["ceilings"]
        print(f"attribution {suite} {h}x{w} bf16: ceilings GEMM {c['gemm']['tflops']:.1f} TFLOP/s "
              f"({c['gemm']['source']}: {c['gemm'].get('op', '')}), copy {c['copy']['gbs']:.1f} GB/s "
              f"({c['copy']['source']}: {c['copy'].get('op', '')}); {wall[suite]:.1f} s wall [{stamp}]")
        for v in r["verify"]:
            print(f"attribution {suite} verify {v['verify']} {h}x{w} bf16: {v['kernel']}, value "
                  f"{tuple(v['value'])}, {v['launches']} launch, max abs err {v['max_abs_err']:.3e}, relative "
                  f"{v['rel']:.3e} (tolerance {v['tolerance']}) [{stamp}]")
            if not v["ok"] or v["launches"] != 1:
                fail(f"attribution {suite}: the {v['verify']} kernel disagrees with the plain version "
                     f"or did not launch once ({v['launches']})")
        for name, rec in r["records"].items():
            if rec.get("reason"):
                print(f"attribution {suite} {name} {h}x{w} bf16: {rec['reason']}")
                continue
            if not (rec["best_sane_ms"] or 0) > 0 or not rec["floor_ms"] > 0:
                fail(f"attribution {suite} {name}: no time or no floor ({rec['best_sane_ms']}, {rec['floor_ms']})")
            tr = rec.get("traced")
            top = f"; top kernel {tr['top_kernels'][0]['name'][:60]} {tr['top_kernels'][0]['ms']:.3f} ms, " \
                  f"kernel share {tr['kernel_share']:.4f}" if tr and tr["top_kernels"] else ""
            scaled = f" (x depth/2: {rec['scaled_ms']:.3f})" if "scaled_ms" in rec else ""
            rate = f", {rec['eff_gb_s']:.1f} GB/s" if "eff_gb_s" in rec else ""
            print(f"attribution {suite} {name} {h}x{w} bf16: {rec['best_sane_ms']:.3f} ms{scaled} (median "
                  f"{rec['median_ms']:.3f}, spread {rec['spread']:.3f}), {rec['gflop']:.2f} GFLOP, "
                  f"{rec['mb']:.1f} MB{rate}, floor {rec['floor_ms']:.3f} ms ({rec['bound_by']}), x "
                  f"{rec['x_over_floor']:.2f}{top} [{stamp}]")
            if tr and tr["kernels"] and suite == "model":
                print(f"attribution model {name} {h}x{w} bf16, traced replay ({'complete' if tr['complete'] else 'incomplete'}"
                      f" after {tr['attempts']} attempt(s)): {tr['kernels']:.0f} kernels over "
                      f"{tr['span_ms']:.3f} ms; ms by class " + ", ".join(
                          f"{k} {v:.3f}" for k, v in tr["by_class_ms"].items()) + "; the five longest: " + "; ".join(
                          f"{k['name'][:70]} {k['ms']:.3f} ms in {k['calls']:.0f}" for k in tr["top_kernels"]))
    recs = results["model"]["records"]
    ms = {n: recs[n]["best_sane_ms"] for n in ("features", "detect", "full")}
    ratio = (ms["features"] + ms["detect"]) / ms["full"]
    print(f"attribution model {h}x{w} bf16: features + detect {ms['features'] + ms['detect']:.3f} ms against "
          f"full {ms['full']:.3f} ({ratio:.4f}; head_minus_features "
          f"{results['model']['summary']['table']['derived']['head_minus_features_ms']:.3f} ms)")
    if abs(ratio - 1) > ATTR_SUM_TOL:
        fail(f"attribution: features + detect is {ratio:.3f} of full (more than {ATTR_SUM_TOL:.0%} off)")
    # each traced stage saw its kernels: K1's encoder and decoder entries
    wanted = {("model", "full"): ("msda_tile_fwd_kernel", "msda_fwd_kernel"),
              ("model", "detect"): ("msda_tile_fwd_kernel", "msda_fwd_kernel"),
              ("encoder", "emsda"): ("msda_tile_fwd_kernel",), ("encoder", "dmsda"): ("msda_fwd_kernel",)}
    for (suite, name), kernels in wanted.items():
        seen = results[suite]["records"][name]["traced"]["port_kernels"]
        if any(not seen.get(k) for k in kernels):
            fail(f"attribution {suite} {name}: its traced replay lacks {kernels} (saw {seen})")
    del model
    wall["all"] = time.perf_counter() - t0
    print("attribution phase, wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1

    # 1. the card; PyTorch's TF32 flags as a user's process has them
    stamp = card()
    print(stamp)
    print(f"TF32 flags left at PyTorch's defaults: torch.backends.cudnn.allow_tf32 "
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    phase_s, t_phase = {}, time.perf_counter()  # wall seconds per phase
    # 2. build, one nvcc per kernel, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(_build.load, KERNELS))
    print(f"built {len(builds)} kernels in {time.perf_counter() - t0:.1f} s wall")
    for built in builds:
        print(f"built {built.path.name} in {built.build_seconds:.1f} s; nvcc -Xptxas -v:")
        print(built.log.strip())
    print_plans(builds, stamp)

    phase_s["build"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 3. kernel vs plain at the main paths' shapes: the forward at every
    # serving size (Swin-L and R50 at 768x1152, R50 at 608x608), the rest
    # at 768x1152
    P = 4
    fwd_errs = {}
    for hw in sorted({(HEIGHT, WIDTH)} | {(h, w) for h, w, _ in R50_SERVING}, reverse=True):
        fwd_errs[f"{hw[0]}x{hw[1]}"], inputs = forward_checks(hw, stamp)
        if hw == (HEIGHT, WIDTH):
            shapes, value, loc_e, w_e, cpk, loc_d, w_d = inputs
        del inputs
    # and at eval_coco's batch: value (4, K, 8, 32), the batch strides
    fwd_errs[f"{HEIGHT}x{WIDTH} batch {EVAL_BATCH}"] = forward_checks((HEIGHT, WIDTH), stamp, batch=EVAL_BATCH)[0]
    torch.cuda.empty_cache()
    K = value.shape[1]

    # the backward kernel against the plain backward, same shapes; its
    # inputs are freed before the serving path, whose peak memory is read
    g_e, g_d = upstream_grads(K)
    enc_b = check_backward(
        f"encoder MSDA backward (packed, Q={K})", value, g_e,
        lambda v, g: split_packed(*msda._launch_packed_bwd(v, shapes, cpk, P, g), 8, len(shapes), P),
        lambda v, g: plain_backward(v, shapes, loc_e, w_e, g), stamp,
    )
    dec_b = check_backward(
        "decoder MSDA backward (reference layout, Q=900)", value, g_d,
        lambda v, g: (lambda gv, gl, gw: (gv, gl[..., 0], gl[..., 1], gw))(
            *msda._launch_reference_bwd(v, shapes, loc_d, w_d, g)),
        lambda v, g: plain_backward(v, shapes, loc_d, w_d, g), stamp,
    )
    # the q-minor entry (K3's counterpart) on the same encoder taps, called
    # directly and through multi_scale_deformable_attention(grid_queries=True):
    # each call launches the q-minor kernel and no other forward
    qm = to_qm(loc_e, w_e)
    before = (msda.launches, msda.launches_qm)
    enc_qm = check_kernel(
        f"encoder MSDA (q-minor, Q={K})", value,
        lambda v: msda.msda_grid_qm(v, shapes, *qm),
        lambda v: msda.msda_reference_qm(v, shapes, *qm), stamp,
    )
    enc_gq = check_kernel(
        f"encoder MSDA (grid_queries=True, Q={K})", value,
        lambda v: msda.multi_scale_deformable_attention(v, shapes, loc_e, w_e, grid_queries=True),
        lambda v: msda.multi_scale_deformable_attention_plain(v, shapes, loc_e, w_e), stamp,
    )
    qm_launches = (msda.launches - before[0], msda.launches_qm - before[1])
    if qm_launches != (0, 4):
        fail(f"the q-minor checks launched (forward, q-minor) kernels {qm_launches}, not (0, 4)")
    enc_qm_b = check_backward(
        f"encoder MSDA backward (q-minor, Q={K})", value, g_e,
        lambda v, g: msda._launch_qm_bwd(v, shapes, *qm, g),
        lambda v, g: plain_backward_qm(v, shapes, *qm, g), stamp,
    )
    del g_e, g_d, qm
    # the tiled encoder kernels on taps placed against their windows
    adversarial = adversarial_checks(stamp)
    # the matching kernel against its plain version and scipy
    matching = hungarian_checks(stamp)

    phase_s["kernel checks"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 4. the whole model's inference forward on the card against the CPU
    # reference (the train step's check follows the serving path, so that
    # its buffers do not count in the serving path's peak memory)
    cfg = CONFIG()
    compare_models(cfg, CHECK_HW, stamp)

    phase_s["model vs CPU"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 5. the main path: Swin-L Inferencer at 768x1152, fp32 then bf16
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, s, np.uint8) for s in ((480, 640, 3), (1280, 720, 3), (900, 1600, 3))]
    swin = serve(cfg, HEIGHT, WIDTH, torch.float32, images, images[0], stamp, post_checks=True)
    main_launches = swin["launches"]
    print(f"main path fp32: {len(images)} images, kernel launches {main_launches} "
          f"({launches_per_forward(cfg)} per forward), kept detections {swin['kept']}")
    swin_bf16 = serve(cfg, HEIGHT, WIDTH, torch.bfloat16, images[1:2], images[0], stamp)

    # bytes left allocated after each phase from here to training, whose
    # peak memory they count in
    held = {"after Swin-L serving": torch.cuda.memory_allocated()}

    # the on-card MSDA gate (the JAX bench.py --verify), which runs the
    # q-minor kernel (K3's counterpart) and the packed one
    msda.launches = msda.launches_qm = msda.launches_bwd = 0
    gate = {dt: verify_msda_on_card(*VERIFY_HW, dt) for dt in (torch.float32, torch.bfloat16)}
    gate_launches = (msda.launches_qm, msda.launches, msda.launches_bwd)
    if gate_launches != (2, 2, 0):
        fail(f"the MSDA gate launched (q-minor, forward, backward) kernels {gate_launches}, not (2, 2, 0)")
    for dt, errs in gate.items():
        print(f"MSDA gate {VERIFY_HW[0]}x{VERIFY_HW[1]} {dt}: q-minor max abs err "
              f"{errs['max_abs_err']:.3e}, packed {errs['max_abs_err_packed']:.3e} (tol "
              f"{1e-4 if dt == torch.float32 else 1e-2}), mean |out| {errs['mean_abs_out']:.4f} [{stamp}]")

    held["after the gate"] = torch.cuda.memory_allocated()

    # the R50 family: the full-width model against the CPU, then serving
    cfg_r50 = co_dino_r50()
    compare_models(cfg_r50, CHECK_HW, stamp, label="R50")
    held["after R50 card vs CPU"] = torch.cuda.memory_allocated()
    r50 = {(h, w, dt): serve(cfg_r50, h, w, dt, images, images[0], stamp) for h, w, dt in R50_SERVING}
    held["after R50 serving"] = torch.cuda.memory_allocated()
    for (h, w, dt), r in r50.items():
        print(f"R50 {h}x{w} {dt}: {len(images)} images, kernel launches {r['launches']} "
              f"({launches_per_forward(cfg_r50)} per forward), kept detections {r['kept']}")

    # the shift-window path (K4): the kernel against its plain version, the
    # corrected dispatch, then the flagship's encoder stage through it; and
    # the gather microbenchmarks (K5)
    shift_errs = shift_checks(stamp)
    shift_adversarial = shift_adversarial_checks(stamp)
    dispatch = dispatch_checks(stamp)
    enc_stage = encoder_stage(cfg, images[-1], stamp)
    gbench = gatherbench_phase(stamp, builds[KERNELS.index("gatherbench")])
    held["after the shift-window and gatherbench phases"] = torch.cuda.memory_allocated()
    print("memory allocated, GiB: " + ", ".join(f"{k} {v / 2**30:.4f}" for k, v in held.items())
          + f" [{stamp}]")

    phase_s["serving, gate, R50, K4, K5"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 6. one train step on the card against the CPU, then the training path,
    # without and with SwinConfig.with_cp; at CP_BATCH images a step needs it
    compare_train_steps(cfg, TRAIN_CHECK_HW, stamp)
    train = run_training(cfg, 1, split=True)
    cfg_cp = replace(cfg, swin=replace(cfg.swin, with_cp=True))
    train_cp = run_training(cfg_cp, 1)
    # the same steps captured in one CUDA graph, beside eager twins
    captured = {"fp32": captured_training(cfg, 1, stamp), "fp32 with_cp": captured_training(cfg_cp, 1, stamp)}
    no_cp_peak = fwd_bwd_peak(cfg, CP_BATCH)
    train_cp_big = run_training(cfg_cp, CP_BATCH, timed=2)

    phase_s["training"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 6b. the losses with no host synchronisation; the bf16-compute step on
    # the card against the CPU's; trainbench (the JAX tools/trainbench.py's
    # gradcheck and bf16 timings at Swin-L 608x608)
    sync_free = sync_free_loss(cfg, stamp)
    torch.cuda.empty_cache()
    bf16_step = compare_bf16_steps(cfg, TRAIN_CHECK_HW, stamp)
    torch.cuda.empty_cache()
    tb = trainbench.main(["--gradcheck"])
    print(f"trainbench (the lines above): Swin-L {tb['H']}x{tb['W']} {tb['dtype']} compute over fp32 "
          f"weights, gradcheck pass {tb['gradcheck']['pass']}; replayed (one CUDA graph a stage, the JAX "
          f"keys): fwd {tb['fwd_ms']:.2f} ms, fwd+bwd {tb['fwdbwd_ms']:.2f} ms, step {tb['step_ms']:.2f} ms, "
          f"bwd/fwd {tb['bwd_over_fwd']}, medians {tb['median_ms']}, spread {tb['spread']}, the step's "
          f"warm-up and capture peak {tb['peak_captured_gib']:.3f} GiB, its graph's pool "
          f"{tb['pool_captured_gib']:.3f} GiB; eager: fwd {tb['fwd_eager_ms']:.2f} ms, fwd+bwd "
          f"{tb['fwdbwd_eager_ms']:.2f} ms, step {tb['step_eager_ms']:.2f} ms, medians "
          f"{tb['median_eager_ms']}, spread {tb['spread_eager']}, peak {tb['peak_gib']:.3f} GiB; matching "
          f"{tb['matching_ms_per_step']:.4f} ms a step in {tb['matching_launches_per_step']} launches [{stamp}]")
    if not tb["gradcheck"]["pass"] or tb["matching_launches_per_step"] != 2:
        fail("trainbench: the gradcheck failed or the step did not launch the matching kernel twice")
    torch.cuda.empty_cache()

    phase_s["sync-free loss, bf16 step, trainbench"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 7. timings
    per_call, per_call_bwd = {}, {}
    for name, v_dtype in (("encoder", torch.float32), ("encoder_bf16", torch.bfloat16),
                          ("decoder", torch.float32), ("decoder_bf16", torch.bfloat16)):
        v = value.to(v_dtype)
        if name.startswith("encoder"):
            kern = functools.partial(msda.msda_grid_packed, v, shapes, cpk, P)
            plain = functools.partial(msda.msda_grid_packed_plain, v, shapes, cpk, P)
            loc, w, reps = loc_e, w_e, (20, 3)
        else:
            kern = functools.partial(msda.multi_scale_deformable_attention, v, shapes, loc_d, w_d)
            plain = functools.partial(
                msda.multi_scale_deformable_attention_plain, v, shapes, loc_d, w_d)
            loc, w, reps = loc_d, w_d, (200, 10)
        b_ms, b_by, nbytes, flops = bound_ms(v, shapes, loc, w, v_dtype)
        r = per_call[name] = {
            "ms": cuda_ms(kern, reps[0]), "plain_ms": cuda_ms(plain, reps[1]),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        }
        direct = ""
        if name.startswith("encoder"):
            # the direct-gather design on the same taps: the reference-layout entry
            r["direct_gather_ms"] = cuda_ms(functools.partial(
                msda.multi_scale_deformable_attention, v, shapes, loc_e, w_e), reps[0])
            direct = (f", direct gather (msda_fwd) on the same taps {r['direct_gather_ms']:.4f} "
                      f"ms/call ({r['direct_gather_ms'] / r['ms']:.2f}x the tiled kernel)")
        print(f"msda_fwd {name}: kernel {r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, "
              f"bound {r['bound_ms']:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP){direct} [{stamp}]")
    share_fwd = msda_tiles.staged_share(msda_tiles.encoder_tile_plan(shapes, torch.float32),
                                        loc_e[..., 0], loc_e[..., 1], w_e)
    share_bwd = msda_tiles.staged_share(msda_tiles.encoder_tile_plan(shapes, torch.float32, backward=True),
                                        loc_e[..., 0], loc_e[..., 1], w_e)
    bench_share = {"fwd": share_fwd[0] / share_fwd[1], "bwd": share_bwd[0] / share_bwd[1]}
    print(f"staged share of the microbenchmark's encoder taps {HEIGHT}x{WIDTH}: forward "
          f"{share_fwd[0]} of {share_fwd[1]} corner reads ({bench_share['fwd']:.6f}), backward "
          f"{share_bwd[0]} ({bench_share['bwd']:.6f}) [{stamp}]")
    # the q-minor kernel (K3's counterpart): at the encoder shapes above
    # and at the gate's 1280x1920 shapes, its own path's calls; beside it
    # the direct-gather design on the same taps (the reference-layout
    # entry) and packing the coordinates for K1, then K1
    per_call_qm = {}
    qm = to_qm(loc_e, w_e)
    gate_in = verify_inputs(*VERIFY_HW, torch.float32)
    for name, v, shp, xyw, reps in (("encoder", value, shapes, qm, (20, 3)),
                                    ("encoder_bf16", value.to(torch.bfloat16), shapes, qm, (20, 3)),
                                    ("gate", gate_in[0], gate_in[1], gate_in[2:], (10, 2)),
                                    ("gate_bf16", gate_in[0].to(torch.bfloat16), gate_in[1], gate_in[2:],
                                     (10, 2))):
        loc_r, w_r = (t.contiguous() for t in from_qm(*xyw))
        b_ms, b_by, nbytes, flops = bound_ms(v, shp, loc_r, w_r, v.dtype)
        served, total = msda_tiles.staged_share(msda_tiles.encoder_tile_plan(shp, v.dtype),
                                                loc_r[..., 0], loc_r[..., 1], w_r)
        r = per_call_qm[name] = {
            "ms": cuda_ms(functools.partial(msda.msda_grid_qm, v, shp, *xyw), reps[0]),
            "plain_ms": cuda_ms(functools.partial(msda.msda_reference_qm, v, shp, *xyw), reps[1]),
            "direct_gather_ms": cuda_ms(functools.partial(
                msda.multi_scale_deformable_attention, v, shp, loc_r, w_r), reps[0]),
            "pack_then_k1_ms": cuda_ms(lambda: msda.msda_grid_packed(
                v, shp, msda.pack_coords_qmajor(*xyw), xyw[0].shape[3]), reps[0]),
            "staged_share": served / total,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        }
        print(f"msda_qm_fwd {name} (K = {v.shape[1]}): kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, direct gather (msda_fwd) on the same taps "
              f"{r['direct_gather_ms']:.4f} ms/call ({r['direct_gather_ms'] / r['ms']:.2f}x), "
              f"pack_coords_qmajor + K1 {r['pack_then_k1_ms']:.4f} ms/call, bound "
              f"{r['bound_ms']:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); "
              f"staged share {r['staged_share']:.6f} [{stamp}]")
        del loc_r, w_r
    del gate_in
    per_call_shift = shift_timings(stamp)

    g_e, g_d = upstream_grads(K)
    for name, v_dtype in (("encoder", torch.float32), ("encoder_bf16", torch.bfloat16),
                          ("decoder", torch.float32), ("decoder_bf16", torch.bfloat16),
                          ("encoder_qm", torch.float32), ("encoder_qm_bf16", torch.bfloat16)):
        v = value.to(v_dtype)
        if name.startswith("encoder_qm"):
            g = g_e.to(v_dtype)
            kern = functools.partial(msda._launch_qm_bwd, v, shapes, *qm, g)
            loc, w, reps = loc_e, w_e, (10, 2)
        elif name.startswith("encoder"):
            g = g_e.to(v_dtype)
            kern = functools.partial(msda._launch_packed_bwd, v, shapes, cpk, P, g)
            # the direct-gather design on the same taps: the reference-layout entry
            direct = functools.partial(msda._launch_reference_bwd, v, shapes, loc_e, w_e, g)
            loc, w, reps = loc_e, w_e, (10, 2)
        else:
            g = g_d.to(v_dtype)
            kern = functools.partial(msda._launch_reference_bwd, v, shapes, loc_d, w_d, g)
            loc, w, reps = loc_d, w_d, (100, 5)
        plain = functools.partial(plain_backward, v.float(), shapes, loc, w, g.float())
        b_ms, b_by, nbytes, flops = bwd_bound_ms(v, shapes, loc, w)
        r = per_call_bwd[name] = {
            "ms": cuda_ms(kern, reps[0]), "plain_ms": cuda_ms(plain, reps[1], warmup=1),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        }
        note = ""
        if name in ("encoder", "encoder_bf16"):
            r["direct_gather_ms"] = cuda_ms(direct, reps[0])
            note = (f", direct gather (msda_bwd) on the same taps {r['direct_gather_ms']:.4f} "
                    f"ms/call ({r['direct_gather_ms'] / r['ms']:.2f}x the tiled kernel)")
        print(f"msda_bwd {name}: kernel {r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, "
              f"bound {r['bound_ms']:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP){note} [{stamp}]")
    match_t = {f"{TRAINBENCH_HW[0]}x{TRAINBENCH_HW[1]} batch 2": matching_timings(sync_free["problems"]),
               f"{HEIGHT}x{WIDTH} batch 1": matching_timings(train["problems"])}
    for name, r in match_t.items():
        print(f"hungarian one step's matching {name} {r['shapes']}: kernel {r['ms']:.4f} ms (2 "
              f"launches), plain {r['plain_ms']:.2f} ms, scipy on the host {r['library_ms']:.3f} ms "
              f"(copy included), bound {r['bound_ms'] * 1e3:.3f} us (bytes) [{stamp}]")
    print_serving(f"Swin-L {HEIGHT}x{WIDTH} fp32", swin, images, stamp)
    print_serving(f"Swin-L {HEIGHT}x{WIDTH} bf16", swin_bf16, images[1:2], stamp)
    for (h, w, dt), r in r50.items():
        print_serving(f"R50 {h}x{w} {'fp32' if dt == torch.float32 else 'bf16'}", r, images, stamp)
    print(f"train fp32 {HEIGHT}x{WIDTH} batch 1: predictions (train_outputs) "
          f"{fmt_ms(train['predict_ms'])}, loss forward {fmt_ms(train['fwd_ms'])} "
          f"(with the matching copied to the host for scipy, the former design: "
          f"{fmt_ms(train['fwd_host_matching_ms'])}; PERF.md section 5 keeps the earlier host-matching "
          f"figure, 144.4-163.0 ms), forward+backward {fmt_ms(train['fwd_bwd_ms'])}, step "
          f"{fmt_ms(train['step_ms'])} ms; "
          f"peak memory allocated over the steps {train['peak_bytes'] / 2**30:.3f} GiB, "
          f"{held_text(train)}; losses {train['losses']} [{stamp}]")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"train fp32 {HEIGHT}x{WIDTH} with_cp, batch 1: step {fmt_ms(train_cp['step_ms'])} ms, "
          f"peak {train_cp['peak_bytes'] / 2**30:.3f} GiB, {held_text(train_cp)}; batch {CP_BATCH}: "
          f"step {fmt_ms(train_cp_big['step_ms'])} ms, peak {train_cp_big['peak_bytes'] / 2**30:.3f} "
          f"GiB, {held_text(train_cp_big)}, losses {train_cp_big['losses']}; batch {CP_BATCH} "
          f"without with_cp, forward+"
          f"backward alone: "
          + ("out of memory" if no_cp_peak is None else f"peak {no_cp_peak / 2**30:.3f} GiB")
          + f" (card {total / 2**30:.1f} GiB) [{stamp}]")
    for (k, r), eager in zip(captured.items(), (train, train_cp)):
        print(f"train {k} {HEIGHT}x{WIDTH} batch 1, the step captured in one CUDA graph: replays "
              f"{fmt_ms(r['step_ms'])} ms (CUDA events; the eager step above {fmt_ms(eager['step_ms'])} ms, "
              f"host clock to a sync); memory: the graph's pool {r['pool'] / 2**30:.3f} GiB, "
              f"{r['held'] / 2**30:.3f} GiB allocated after the capture, peak {r['peak_bytes'] / 2**30:.3f} "
              f"GiB allocated over the warm-up and capture (the eager steps' peak "
              f"{eager['peak_bytes'] / 2**30:.3f}) [{stamp}]")

    phase_s["timings"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 8. the deployment path: BASELINE configs[0] and [3] exported, saved and
    # reloaded; the five-configuration matrix timed as CUDA-graph replays
    # beside eager calls; the reloaded fused program behind the batch-4
    # Inferencer; one traced image
    more = [np.random.default_rng(SEED + 1).integers(0, 256, s, np.uint8) for s in ((720, 1280, 3), (600, 800, 3))]
    wall = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        exported = export_phase(tmp, images[-1], stamp)
        wall["export"], t0 = time.perf_counter() - t0, time.perf_counter()
        matrix = matrix_phase(exported, MATRIX_ITERATIONS, stamp)
        wall["matrix"], t0 = time.perf_counter() - t0, time.perf_counter()
        reloaded = {f"configs{i}": {k: v for k, v in r.items() if k != "program"} for i, r in exported.items()}
        del exported
        fused = fused_phase(tmp, images + more, stamp)
        seeded_model.cache_clear()
        torch.cuda.empty_cache()
        wall["fused"], t0 = time.perf_counter() - t0, time.perf_counter()
        trace_phase(tmp, images[-1], stamp)
        wall["trace"], t0 = time.perf_counter() - t0, time.perf_counter()
        evaluation = eval_phase(tmp, stamp)
        wall["eval_coco"] = time.perf_counter() - t0
    print("deployment phases, wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in wall.items()))
    phase_s["deployment"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 9. checkpoint day: the rehearsal
    with tempfile.TemporaryDirectory() as tmp:
        rehearsed = rehearsal_phase(tmp, enc_stage, stamp)
    phase_s["rehearsal"], t_phase = time.perf_counter() - t_phase, time.perf_counter()
    # 10. stage attribution at 1280x1920 bf16 (codetr_torch.tools.attr)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        attribution = attribution_phase(tmp, stamp)
    phase_s["attribution"] = time.perf_counter() - t_phase
    print("phases, wall seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in phase_s.items()))

    tc = cfg.head.transformer
    n_enc, n_dec = tc.num_encoder_layers, tc.num_decoder_layers  # launches per forward
    enc_r, dec_r = per_call["encoder"], per_call["decoder"]
    kernels = {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "codetr_torch/csrc/msda_fwd.cu",
        "replaces": "codetr_tpu/ops/msda_win.py:711",
        "launches": main_launches,
        # over the checks at every serving size
        "max_abs_err": max(e["max_abs_err_fp32"] for pair in fwd_errs.values() for e in pair),
        "checked_at": list(fwd_errs),
        # one fp32 forward's work: 6 encoder calls + 6 decoder calls
        "ms": n_enc * enc_r["ms"] + n_dec * dec_r["ms"],
        "plain_ms": n_enc * enc_r["plain_ms"] + n_dec * dec_r["plain_ms"],
        "bound_ms": n_enc * enc_r["bound_ms"] + n_dec * dec_r["bound_ms"],
        "bound_by": enc_r["bound_by"],
        "library_ms": None,
        "per_call": per_call,
        "max_abs_err_bf16": max(e["max_abs_err_bf16"] for pair in fwd_errs.values() for e in pair),
        "encoder_design": "shared-memory query tiles (msda_packed_fwd); decoder: direct gather",
        # the exported, reloaded programs (each forward, launches at capture for
        # the graph replays), the matrix's per call, the fused Inferencer's
        "launches_reloaded_per_forward": {k: r["launches"] for k, r in reloaded.items()},
        # one replay of each captured train step, from its trace (K1 and the decoder's entry)
        "launches_captured_step": {k: {n: r["counts"][n] for n in ("msda_tile_fwd_kernel", "msda_fwd_kernel")}
                                   for k, r in captured.items()},
        "launches_matrix_per_call": {spec_label(spec): r["msda_launches_per_call"]
                                     for spec, r in zip(MATRIX, matrix)},
        "launches_fused_inferencer": fused["launches"],
        # eval_coco's pass 3 (the JAX script's defaults), over its served batches
        "launches_eval_coco": evaluation["pass 3 (1)"]["launches"][0],
        # the checkpoint rehearsal's bf16 reader (the counts set to 0 before
        # its forwards), its fp32 reader, and K1 on the first encoder layer's
        # taps of seed 0's, the file's and the scale-2.0 model
        "launches_rehearsal": rehearsed["record"]["msda_launches"]["forward"],
        "launches_rehearsal_fp32": rehearsed["fp32_launches"],
        # stage attribution's full Swin-L 1280x1920 bf16 forward, a replay's
        # kernels from its trace (K1's encoder and decoder entries)
        "launches_attribution_full_replay": attribution["model"]["records"]["full"]["traced"]["port_kernels"],
        "rehearsal_taps": rehearsed["k1"],
        "staged_share": {"microbenchmark": bench_share["fwd"], "swin_l_encoder": enc_stage["staged_share"],
                         "rehearsal_bf16_reader": rehearsed["record"]["staged_share"]["overall"],
                         "tile_adversarial": {k: r["staged_share"] for k, r in adversarial.items()}},
        "max_abs_err_tile_adversarial": {k: r["fwd"] for k, r in adversarial.items()},
        "card": stamp,
    }, {
        "name": "msda_qm_fwd",
        "route": "cuda",
        "source": "codetr_torch/csrc/msda_fwd.cu",
        "replaces": "codetr_tpu/ops/msda_win.py:605",
        "launches": gate_launches[0],  # the gate's fp32 and bf16 calls
        "max_abs_err": max(enc_qm["max_abs_err_fp32"], enc_gq["max_abs_err_fp32"],
                           gate[torch.float32]["max_abs_err"]),
        # one fp32 call of the gate's path, at 1280x1920
        "ms": per_call_qm["gate"]["ms"],
        "plain_ms": per_call_qm["gate"]["plain_ms"],
        "bound_ms": per_call_qm["gate"]["bound_ms"],
        "bound_by": per_call_qm["gate"]["bound_by"],
        "library_ms": None,
        "per_call": per_call_qm,
        "max_abs_err_bf16": max(enc_qm["max_abs_err_bf16"], enc_gq["max_abs_err_bf16"],
                                gate[torch.bfloat16]["max_abs_err"]),
        "out_of_envelope_count": "n/a: exact kernel",
        "design": "shared-memory query tiles, K1's plan and loop (msda_tiles.cuh), q-minor coordinates "
                  "read to registers",
        "staged_share": {"gate": per_call_qm["gate"]["staged_share"],
                         "microbenchmark": per_call_qm["encoder"]["staged_share"],
                         "tile_adversarial": {k: r["staged_share"] for k, r in adversarial.items()}},
        # the direct-gather design on the gate's taps: the reference-layout entry
        "direct_gather_ms": per_call_qm["gate"]["direct_gather_ms"],
        "pack_then_k1_ms": per_call_qm["gate"]["pack_then_k1_ms"],
        "max_abs_err_tile_adversarial": {k: r["fwd_qm"] for k, r in adversarial.items()},
        "card": stamp,
    }, {
        "name": "msda_bwd",
        "route": "cuda",
        "source": "codetr_torch/csrc/msda_bwd.cu",
        "replaces": "codetr_tpu/ops/msda_win_bwd.py:306",
        "launches": train["launches"]["msda_bwd"],  # over the 3 timed train steps
        "launches_per_step": n_enc + n_dec,
        # one replay of each captured train step, from its trace (K2 and the decoder's entry)
        "launches_captured_step": {k: {n: r["counts"][n] for n in ("msda_tile_bwd_kernel", "msda_bwd_kernel")}
                                   for k, r in captured.items()},
        "max_abs_err": max(enc_b["max_abs_err_fp32"], dec_b["max_abs_err_fp32"]),
        # one fp32 train step's work: 6 encoder calls + 6 decoder calls
        "ms": n_enc * per_call_bwd["encoder"]["ms"] + n_dec * per_call_bwd["decoder"]["ms"],
        "plain_ms": (n_enc * per_call_bwd["encoder"]["plain_ms"]
                     + n_dec * per_call_bwd["decoder"]["plain_ms"]),
        "bound_ms": (n_enc * per_call_bwd["encoder"]["bound_ms"]
                     + n_dec * per_call_bwd["decoder"]["bound_ms"]),
        "bound_by": per_call_bwd["encoder"]["bound_by"],
        "library_ms": None,
        "per_call": per_call_bwd,
        "max_abs_err_bf16": max(enc_b["max_abs_err_bf16"], dec_b["max_abs_err_bf16"]),
        "max_abs_err_qm": enc_qm_b["max_abs_err_fp32"],
        "encoder_design": ("shared-memory query tiles, the value gradient summed per window pixel "
                           "(msda_packed_bwd); decoder, q-minor: direct gather"),
        "staged_share": {"microbenchmark": bench_share["bwd"]},
        "max_abs_err_tile_adversarial": {k: r["bwd"] for k, r in adversarial.items()},
        "card": stamp,
    }, {
        "name": "msda_shift_fwd",
        "route": "cuda",
        "source": "codetr_torch/csrc/msda_shift_fwd.cu",
        "replaces": "codetr_tpu/ops/msda_pallas.py:466",
        "launches": enc_stage["launches"]["msda_shift_fwd"],  # the encoder stage's
        "max_abs_err": max(e["max_abs_err_fp32"] for e in shift_errs.values()),
        "checked_at": [f"{h}x{w} radius {r} max_window {m}" for (h, w), r, m in shift_errs],
        # one fp32 encoder stage's work: one call per encoder layer
        "ms": n_enc * per_call_shift["encoder"]["ms"],
        "plain_ms": n_enc * per_call_shift["encoder"]["plain_ms"],
        "bound_ms": n_enc * per_call_shift["encoder"]["bound_ms"],
        "bound_by": per_call_shift["encoder"]["bound_by"],
        "library_ms": None,
        "per_call": per_call_shift,
        "max_abs_err_bf16": max(e["max_abs_err_bf16"] for e in shift_errs.values()),
        "dispatch_rel_err": {k: v for k, v in dispatch.items() if k != "out_of_envelope"},
        "out_of_envelope_count": {"dispatch": dispatch["out_of_envelope"],
                                  "encoder_layers": enc_stage["out_of_envelope"]},
        "encoder_stage_ms": enc_stage["ms"],
        "design": "shared-memory query tiles (msda_tiles.cuh's loop) with windows around the anchors "
                  "(shift_tile_plan)",
        "staged_share": {"timing_taps": per_call_shift["staged_share"],
                         "tile_adversarial": {k: r["staged_share"] for k, r in shift_adversarial.items()}},
        # the same kernel with no pair staged (every corner from global
        # memory), 6 calls
        "direct_gather_ms": n_enc * per_call_shift["encoder"]["direct_gather_ms"],
        "max_abs_err_tile_adversarial": {k: {e: r[e] for e in ("max_abs_err_fp32", "max_abs_err_bf16")}
                                         for k, r in shift_adversarial.items()},
        "card": stamp,
    }, {
        "name": "gatherbench",
        "route": "cuda",
        "source": "codetr_torch/csrc/gatherbench.cu",
        "replaces": "tools/gatherbench.py:48",
        "launches": gbench["launches"],  # the sweep's: each case's kernel and its floor
        "launches_by_entry": gbench["by_entry"],
        "max_abs_err": max(gbench["errs"].values()),
        "checked_at": sorted(gbench["errs"]),
        # the whole sweep: one call of each case
        "ms": sum(r["ms"] for r in gbench["results"].values()),
        "plain_ms": sum(r["plain_ms"] for r in gbench["results"].values()),
        "bound_ms": sum(r["bound_ms"] for r in gbench["results"].values()),
        "bound_by": max(gbench["results"].values(), key=lambda r: r["bound_ms"])["bound_by"],
        # R one-plane PyTorch calls per case
        "library_ms": sum(r["library_us"] for r in gbench["results"].values()) * gbench["R"] / 1e3,
        # the empty kernel at each case's launch geometry, one call per case
        "floor_ms": sum(r["floor_ms"] for r in gbench["results"].values()),
        "smem_wavefront_ms": {k: r["smem_wavefront_ms"] for k, r in gbench["results"].items()
                              if "smem_wavefront_ms" in r},
        "design": {
            "gather_sub": "a stripe of n + R - 1 128-byte rows, a column (bf16: a word) per lane, "
                          "its tensor-map boxes multicast to a cluster of two row groups",
            "gather_lane": "a block per row of m + R - 1 words, a column per lane",
            "idxadd": "the index's mirror by one VIADDMNMX, an int32 sum converted once",
            "splat2": "a thread per plane element, the iteration an immediate",
            "fma1": "a thread per element, the iteration an immediate",
        },
        "sass_i2f": gbench["sass"],
        "lane_conflicts": gbench["conflicts"],
        "gather_sub_clusters": gbench["clusters"],
        "per_case": gbench["results"],
        "card": stamp,
    }, {
        "name": "hungarian",
        "route": "cuda",
        "source": "codetr_torch/csrc/hungarian.cu",
        # not a Pallas kernel: optax.assignment.hungarian_algorithm under XLA
        "replaces": "codetr_tpu/parallel/losses.py:116",
        "launches": train["launches"]["hungarian"],  # over the 3 timed train steps
        "launches_per_step": 2,
        # one replay of each captured train step, from its trace
        "launches_captured_step": {k: r["counts"]["hungarian_kernel"] for k, r in captured.items()},
        # column indices against the plain version's (equal: 0)
        "max_abs_err": max(r["max_abs_err"] for r in matching.values()),
        # the valid rows' total cost against scipy's
        "cost_rel_err_vs_scipy": max(r["cost_rel_err_vs_scipy"] for r in matching.values()),
        "checked_at": sorted(matching),
        # one fp32 768x1152 step's two launches on its own costs
        "ms": match_t[f"{HEIGHT}x{WIDTH} batch 1"]["ms"],
        "plain_ms": match_t[f"{HEIGHT}x{WIDTH} batch 1"]["plain_ms"],
        "bound_ms": match_t[f"{HEIGHT}x{WIDTH} batch 1"]["bound_ms"],
        "bound_by": "bytes",
        # scipy's linear_sum_assignment on the host, the copy included
        "library_ms": match_t[f"{HEIGHT}x{WIDTH} batch 1"]["library_ms"],
        "per_step": match_t,
        "per_case": matching,
        "sync_free_loss_launches": sync_free["launches"],
        "trainbench_ms_per_step": tb["matching_ms_per_step"],
        "design": "one block per problem, its branch decided on the card from its valid rows V: the "
                  "valid rows' search (V <= C) or the transposed problem (V > C, optax's answer); per "
                  "step one pass over the columns, a block argmin with the lowest-index tie rule; "
                  "per-column state in shared memory up to ~9,000 columns, else in a global scratch",
        "card": stamp,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
