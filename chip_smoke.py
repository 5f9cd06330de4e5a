#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every part of it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a result):
1. identify the card (nvidia-smi name and power limit, torch/CUDA versions);
2. build the CUDA kernels from ``codetr_torch/csrc``, one nvcc each, all at
   once (build seconds and ``-Xptxas -v`` printed);
3. hold the MSDA forward and backward kernels against their plain PyTorch
   versions at the 768x1152 main-path shapes (encoder: 5 levels, K = 73,656
   queries, packed and q-minor layouts, the latter also through
   ``multi_scale_deformable_attention(grid_queries=True)``; decoder: 900
   queries with 4-coordinate references), and the forward's packed and
   reference entries at R50's 608x608 shapes too (K = 30,785), value in
   fp32 and in bf16;
4. check the full-width Swin-L model's inference forward on the card
   against the same model run on the CPU through the plain versions, at a
   small input;
5. the serving path: 3 synthetic images of different sizes through the
   Swin-L ``Inferencer`` at 768x1152 in fp32 and one in bf16, checking the
   outputs and that each forward launched the forward kernel 12 times (6
   encoder + 6 decoder layers); then the on-card MSDA gate
   (``codetr_torch.bench.verify_msda_on_card``, the JAX ``bench.py
   --verify``) at 1280x1920 in fp32 and bf16, which launches the q-minor
   kernel; then the R50 family: its full-width model on the card against
   the CPU at a small input, and the ``Inferencer`` at 608x608 fp32 and at
   768x1152 bf16 (3 images each, 12 forward launches per image); then the
   shift-window MSDA kernel (K4) against its plain version at the 768x1152
   and 608x608 encoder shapes (radius 5 and 4, and a window limit that
   sends every cross-level pair through the coarse-pair escape), the
   corrected ``msda_grid_qm(impl="grid_pallas" | "grid")`` against the
   exact function with its launch counts and its gradient, the Swin-L
   encoder stage with ``msda_impl="grid_pallas"`` against ``"auto"`` (one
   K4 launch per layer, one K3 correction per layer with taps outside the
   envelope, no K1), and the gather microbenchmarks (K5) against their
   plain versions, then their sweep;
6. one full-width Swin-L train step on the card against the CPU at a small
   input (loss and every gradient, each leaf held against its own measured
   sensitivity); then the training path: Swin-L train steps at 768x1152,
   batch 1, synthetic boxes, and with ``SwinConfig.with_cp`` at batch 1 and
   at a batch that does not fit the card without it, checking that each
   step launched the forward and the backward kernel 12 times each and that
   the loss stays finite;
7. time the kernels, their plain versions, the end-to-end latency and the
   train step, and print them beside the card's name and power limit, then
   the ``kernels`` line and, last, the result line.

All comparisons run with TF32 off (``allow_tf32 = False`` for matmul and
cuDNN), so fp32 means fp32 on both sides; the latency and step figures are
therefore full-fp32 figures too.
"""

from __future__ import annotations

import copy
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np
import torch

from codetr_torch import Inferencer, build_codetr, co_dino_r50, co_dino_swin_l
from codetr_torch.bench import verify_inputs, verify_msda_on_card
from codetr_torch.ops import _build
from codetr_torch.ops import msda, msda_grid
from codetr_torch.parallel.losses import dino_detection_loss
from codetr_torch.parallel.train import adamw, make_train_step

HEIGHT, WIDTH = 768, 1152  # the serving size
VERIFY_HW = (1280, 1920)  # the on-card MSDA gate's size, the JAX bench.py's default
R50_SERVING = ((608, 608, torch.float32), (768, 1152, torch.bfloat16))  # BASELINE configs[0], [1]
CHECK_HW = (384, 384)  # small input for the card-vs-CPU model check
TRAIN_CHECK_HW = (256, 256)  # small input for the card-vs-CPU train-step check (K = 5,456)
PERTURBATIONS = 3  # seeded 1e-7 weight perturbations that measure each gradient's spread
CP_BATCH = 6  # a train batch whose step does not fit the card without SwinConfig.with_cp
KERNELS = ("msda_fwd", "msda_bwd", "msda_shift_fwd", "gatherbench")
SEED = 0
DEVICE = "cuda"
CONFIG = co_dino_swin_l
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, fp32
# FLOP/s outside the tensor cores (the kernel's FMAs run on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


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


def msda_inputs(shapes, num_queries, heads=8, dim=32, points=4, decoder=False):
    """Seeded inputs on the card: value (1, K, h, d) fp32; locations (1, Q,
    h, L, P, 2) and weights (1, Q, h, L, P) fp32.  Taps mix offsets of a
    few pixels around each query, far-out taps (beyond the level) and
    exact-integer pixel taps."""
    dev = DEVICE
    g = torch.Generator(device=dev).manual_seed(SEED)
    K = sum(h * w for h, w in shapes)
    Q, L = num_queries, len(shapes)
    value = torch.randn(1, K, heads, dim, generator=g, device=dev)
    if decoder:
        ctr = torch.rand(1, Q, 1, 1, 1, 2, generator=g, device=dev) * 0.8 + 0.1
        wh = torch.rand(1, Q, 1, 1, 1, 2, generator=g, device=dev) * 0.3 + 0.02
        off = torch.randn(1, Q, heads, L, points, 2, generator=g, device=dev) * 2.0
        loc = ctr + off / points * wh * 0.5
    else:
        refs = torch.cat([
            torch.stack(torch.meshgrid(
                (torch.arange(w, device=dev) + 0.5) / w, (torch.arange(h, device=dev) + 0.5) / h,
                indexing="xy"), -1).reshape(-1, 2)
            for h, w in shapes
        ])  # (K, 2) xy
        size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)
        off = torch.randn(1, Q, heads, L, points, 2, generator=g, device=dev) * 4.0
        loc = refs[None, :, None, None, None, :] + off / size[None, None, None, :, None, :]
    far = torch.rand(loc.shape[:-1], generator=g, device=dev) < 0.05
    loc = torch.where(far[..., None], torch.rand(loc.shape, generator=g, device=dev) * 4 - 1.5, loc)
    exact = torch.rand(loc.shape[:-1], generator=g, device=dev) < 0.1
    size = torch.tensor([[w, h] for h, w in shapes], dtype=torch.float32, device=dev)[:, None, :]
    snapped = (torch.round(loc * size - 0.5) + 0.5) / size
    loc = torch.where(exact[..., None], snapped, loc).contiguous()
    w = torch.randn(1, Q, heads, L * points, generator=g, device=dev).softmax(-1)
    return value, loc, w.reshape(1, Q, heads, L, points).contiguous()


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


def forward_checks(hw, stamp, points=4):
    """The forward kernel's packed (encoder, Q = K) and reference-layout
    (decoder, Q = 900) entries against their plain versions at an input
    size's level shapes -> ((encoder errors, decoder errors), (shapes,
    value, loc_e, w_e, cpk, loc_d, w_d))."""
    shapes = level_shapes(*hw)
    K = sum(h * w for h, w in shapes)
    size = f"{hw[0]}x{hw[1]}"
    print(f"levels at {size}: {shapes}, K = {K}")
    value, loc_e, w_e = msda_inputs(shapes, K)
    cpk = pack(loc_e, w_e)
    _, loc_d, w_d = msda_inputs(shapes, 900, decoder=True)
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

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
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
    step(x, mask, *targets)  # warm-up step: the optimizer's state
    torch.cuda.synchronize()
    res["held"] = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    per = launches_per_forward(cfg)
    msda.launches = msda.launches_bwd = 0
    step_ms, losses, per_step = [], [], []
    for _ in range(timed):
        f0, b0 = msda.launches, msda.launches_bwd
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(x, mask, *targets).item())
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        per_step.append((msda.launches - f0, msda.launches_bwd - b0))
    launches = {"msda_fwd": msda.launches, "msda_bwd": msda.launches_bwd}
    peak = torch.cuda.max_memory_allocated()
    if any(p != (per, per) for p in per_step):
        fail(f"train steps launched (forward, backward) kernels {per_step}, not {per} each")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss {losses}")
    print(f"training path fp32 {HEIGHT}x{WIDTH} batch {batch}, with_cp "
          f"{cfg.swin.with_cp}: {timed} steps, kernel launches per step {per_step}, "
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
        dino_detection_loss(model.train_outputs(x, mask), *targets)[0].backward()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    except torch.cuda.OutOfMemoryError:
        peak = None
    del model, x, mask, targets
    gc.collect()
    torch.cuda.empty_cache()
    return peak


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
        if d.min() > 0.5:
            unmatched += 1
            continue
        used[cand[np.argmin(d)]] = True
    print(f"{label} {h}x{w} card vs CPU: features rel err {feat_err:.3e}, encoder memory "
          f"{mem_err:.3e}, encoder class logits {cls_err:.3e} (tol 2e-4 each); "
          f"{k - shared}/{k} top-k proposals differ; scores err {score_err:.3e} (tol 1e-3), "
          f"unmatched boxes {unmatched}/{len(cb)} at 0.5 px (tol {len(cb) // 100}) [{stamp}]")
    if (max(feat_err, mem_err, cls_err) > 2e-4 or score_err > 1e-3
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


def serve(cfg, height, width, dtype, images, warmup):
    """One serving configuration: the ``Inferencer`` at batch 1 after one
    warm-up image, then each of ``images`` timed on the host clock with the
    launch counts set to 0 before and read after (each forward must launch
    the forward kernel once per encoder and decoder layer, and no other);
    then one forward of the last image timed piece by piece."""
    from codetr_torch.ops.nms import postprocess_detections
    from codetr_torch.utils.preprocess import preprocess

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
        _, t_post = timed(lambda: postprocess_detections(
            *det, score_threshold=0.0, iou_threshold=cfg.head.nms_iou_threshold,
            nms_type=cfg.head.nms_type))
    del model, inf, feats, det
    torch.cuda.empty_cache()
    return {"latencies": latencies, "split": (t_pre, t_feat, t_det, t_post), "peak": peak,
            "held": held, "launches": launches[0], "kept": [int(d.keep.sum()) for d in dets]}


def print_serving(label, r, images, stamp):
    for im, t in zip(images, r["latencies"]):
        print(f"latency {label} image {im.shape[:2]}: {t:.2f} ms [{stamp}]")
    print(f"latency {label} median: {statistics.median(r['latencies']):.2f} ms per image [{stamp}]")
    t_pre, t_feat, t_det, t_post = r["split"]
    print(f"{label} split, one image: preprocess {t_pre:.2f} ms, backbone+neck {t_feat:.2f} ms, "
          f"head {t_det:.2f} ms, soft-NMS {t_post:.2f} ms [{stamp}]")
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
    launch per layer with taps out of the envelope, no K1.  Returns the
    per-layer out-of-envelope counts, the launches and both impls' times."""
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
        mem_auto = tf.encode(feats, masks, pos)[0]
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
    print(f"Swin-L encoder stage {HEIGHT}x{WIDTH} fp32, grid_pallas vs auto: memory error "
          f"{err:.3e} of scale (tol 1e-4); launches {launches}; out-of-envelope taps per layer "
          f"{layer_counts} of {n_taps}; encoder stage ms grid_pallas "
          f"{fmt_ms(times['grid_pallas'])}, auto {fmt_ms(times['auto'])} [{stamp}]")
    want = {"msda_shift_fwd": n_layers, "msda_qm_fwd": corrected, "msda_fwd": 0}
    if launches != want or not err < 1e-4 or not torch.isfinite(mem_grid).all():
        fail(f"encoder stage: launches {launches} (want {want}), memory error {err}")
    del model, grid_enc, feats, mem_grid, mem_auto
    torch.cuda.empty_cache()
    return {"launches": launches, "out_of_envelope": layer_counts, "err": err, "ms": times}


def shift_timings(stamp):
    """K4 per call at 768x1152 (radius 5, the jitter-only taps: every tap in
    its window, so the truncated function is the exact one and the bytes
    bound counts the rows the taps touch), fp32 and bf16, beside its plain
    version and K3 on the same taps."""
    value, shapes, x, y, w = shift_inputs((HEIGHT, WIDTH), far=0.0)
    per_call = {}
    for name, v in (("encoder", value), ("encoder_bf16", value.to(torch.bfloat16))):
        b_ms, b_by, nbytes, flops = bound_ms(v, shapes, *from_qm(x, y, w), v.dtype)
        r = per_call[name] = {
            "ms": cuda_ms(functools.partial(msda_grid.msda_grid_shift_qm, v, shapes, x, y, w,
                                            radius=GRID_RADIUS), 20),
            "plain_ms": cuda_ms(functools.partial(msda_grid.msda_shift_plain, v, shapes, x, y, w,
                                                  GRID_RADIUS), 3),
            "k3_ms": cuda_ms(functools.partial(msda.msda_grid_qm, v, shapes, x, y, w), 20),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        }
        print(f"msda_shift_fwd {name} (K = {v.shape[1]}, radius {GRID_RADIUS}): kernel "
              f"{r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, K3 on the same taps "
              f"{r['k3_ms']:.4f} ms/call, bound {b_ms:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP) [{stamp}]")
    return per_call


def gatherbench_phase(stamp):
    """K5: each op's kernel against its plain version at every size of the
    sweep (the gathers and idxadd bit for bit; fma1 and splat2, whose
    kernels round differently, within 1e-6 of the checksum's scale), then
    the sweep itself, with the launch count set to 0 just before and read
    just after."""
    from codetr_torch.tools import gatherbench as gb

    errs = {}
    for key, op, size, dtype in gb.cases():
        inputs = gb.make_inputs(op, size, dtype)
        got, want = gb.KERNEL[op](*inputs), gb.PLAIN[op](*inputs)
        torch.cuda.synchronize()
        err = errs[key] = (got - want).abs().max().item()
        tol = 0.0 if op in ("gather_sub", "gather_lane", "idxadd") else 1e-6 * want.abs().max().item()
        if got.shape != (8, 128) or not err <= tol:
            fail(f"gatherbench {key}: checksum off by {err} (tol {tol})")
    print(f"gatherbench: {len(errs)} checksums against their plain versions, largest error "
          f"{max(errs.values()):.3e} (gathers and idxadd exact; fma1, splat2 1e-6 of scale) [{stamp}]")
    gb.launches = 0
    results = gb.sweep()
    torch.cuda.synchronize()
    launches = gb.launches
    for key, r in results.items():
        print(f"gatherbench {key}: {r['us_per_op']:.4f} us per op and iteration ({r['ms']:.4f} ms "
              f"per call), bound {r['bound_ms'] * 1e3 / gb.R:.4f} us ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms per call, one PyTorch call per plane {r['library_us']:.2f} us "
              f"[{stamp}]")
    return {"errs": errs, "results": results, "launches": launches, "R": gb.R}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU", file=sys.stderr)
        return 1
    # reference comparisons below are full fp32 on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    stamp = card()
    print(stamp)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    # 2. build, one nvcc per kernel, all started together
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = list(pool.map(_build.load, KERNELS))
    print(f"built {len(builds)} kernels in {time.perf_counter() - t0:.1f} s wall")
    for built in builds:
        print(f"built {built.path.name} in {built.build_seconds:.1f} s; nvcc -Xptxas -v:")
        print(built.log.strip())

    # 3. kernel vs plain at the main paths' shapes: the forward at every
    # serving size (Swin-L and R50 at 768x1152, R50 at 608x608), the rest
    # at 768x1152
    P = 4
    fwd_errs = {}
    for hw in sorted({(HEIGHT, WIDTH)} | {(h, w) for h, w, _ in R50_SERVING}, reverse=True):
        fwd_errs[hw], inputs = forward_checks(hw, stamp)
        if hw == (HEIGHT, WIDTH):
            shapes, value, loc_e, w_e, cpk, loc_d, w_d = inputs
        del inputs
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

    # 4. the whole model's inference forward on the card against the CPU
    # reference (the train step's check follows the serving path, so that
    # its buffers do not count in the serving path's peak memory)
    cfg = CONFIG()
    compare_models(cfg, CHECK_HW, stamp)

    # 5. the main path: Swin-L Inferencer at 768x1152, fp32 then bf16
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, s, np.uint8) for s in ((480, 640, 3), (1280, 720, 3), (900, 1600, 3))]
    swin = serve(cfg, HEIGHT, WIDTH, torch.float32, images, images[0])
    main_launches = swin["launches"]
    print(f"main path fp32: {len(images)} images, kernel launches {main_launches} "
          f"({launches_per_forward(cfg)} per forward), kept detections {swin['kept']}")
    swin_bf16 = serve(cfg, HEIGHT, WIDTH, torch.bfloat16, images[1:2], images[0])

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
    r50 = {(h, w, dt): serve(cfg_r50, h, w, dt, images, images[0]) for h, w, dt in R50_SERVING}
    held["after R50 serving"] = torch.cuda.memory_allocated()
    for (h, w, dt), r in r50.items():
        print(f"R50 {h}x{w} {dt}: {len(images)} images, kernel launches {r['launches']} "
              f"({launches_per_forward(cfg_r50)} per forward), kept detections {r['kept']}")

    # the shift-window path (K4): the kernel against its plain version, the
    # corrected dispatch, then the flagship's encoder stage through it; and
    # the gather microbenchmarks (K5)
    shift_errs = shift_checks(stamp)
    dispatch = dispatch_checks(stamp)
    enc_stage = encoder_stage(cfg, images[-1], stamp)
    gbench = gatherbench_phase(stamp)
    held["after the shift-window and gatherbench phases"] = torch.cuda.memory_allocated()
    print("memory allocated, GiB: " + ", ".join(f"{k} {v / 2**30:.4f}" for k, v in held.items())
          + f" [{stamp}]")

    # 6. one train step on the card against the CPU, then the training path,
    # without and with SwinConfig.with_cp; at CP_BATCH images a step needs it
    compare_train_steps(cfg, TRAIN_CHECK_HW, stamp)
    train = run_training(cfg, 1, split=True)
    cfg_cp = replace(cfg, swin=replace(cfg.swin, with_cp=True))
    train_cp = run_training(cfg_cp, 1)
    no_cp_peak = fwd_bwd_peak(cfg, CP_BATCH)
    train_cp_big = run_training(cfg_cp, CP_BATCH, timed=2)

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
        print(f"msda_fwd {name}: kernel {r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, "
              f"bound {r['bound_ms']:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP) [{stamp}]")
    # the q-minor kernel (K3's counterpart): at the encoder shapes above
    # and at the gate's 1280x1920 shapes, its own path's call
    per_call_qm = {}
    qm = to_qm(loc_e, w_e)
    gate_in = verify_inputs(*VERIFY_HW, torch.float32)
    for name, v, shp, xyw, reps in (("encoder", value, shapes, qm, (20, 3)),
                                    ("encoder_bf16", value.to(torch.bfloat16), shapes, qm, (20, 3)),
                                    ("gate", gate_in[0], gate_in[1], gate_in[2:], (10, 2))):
        b_ms, b_by, nbytes, flops = bound_ms(v, shp, *from_qm(*xyw), v.dtype)
        r = per_call_qm[name] = {
            "ms": cuda_ms(functools.partial(msda.msda_grid_qm, v, shp, *xyw), reps[0]),
            "plain_ms": cuda_ms(functools.partial(msda.msda_reference_qm, v, shp, *xyw), reps[1]),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "flops": flops,
        }
        print(f"msda_qm_fwd {name} (K = {v.shape[1]}): kernel {r['ms']:.4f} ms/call, plain "
              f"{r['plain_ms']:.4f} ms/call, bound {r['bound_ms']:.4f} ms ({b_by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) [{stamp}]")
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
        print(f"msda_bwd {name}: kernel {r['ms']:.4f} ms/call, plain {r['plain_ms']:.4f} ms/call, "
              f"bound {r['bound_ms']:.4f} ms ({b_by}: {nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP) [{stamp}]")
    print_serving(f"Swin-L {HEIGHT}x{WIDTH} fp32", swin, images, stamp)
    print_serving(f"Swin-L {HEIGHT}x{WIDTH} bf16", swin_bf16, images[1:2], stamp)
    for (h, w, dt), r in r50.items():
        print_serving(f"R50 {h}x{w} {'fp32' if dt == torch.float32 else 'bf16'}", r, images, stamp)
    print(f"train fp32 {HEIGHT}x{WIDTH} batch 1: predictions (train_outputs) "
          f"{fmt_ms(train['predict_ms'])}, loss forward {fmt_ms(train['fwd_ms'])}, "
          f"forward+backward {fmt_ms(train['fwd_bwd_ms'])}, step {fmt_ms(train['step_ms'])} ms; "
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

    tc = cfg.head.transformer
    n_enc, n_dec = tc.num_encoder_layers, tc.num_decoder_layers  # launches per forward
    enc_r, dec_r = per_call["encoder"], per_call["decoder"]
    kernels = {"kernels": [{
        "name": "msda_fwd",
        "route": "cuda",
        "source": "codetr_torch/csrc/msda_fwd.cu",
        "replaces": "codetr_tpu/ops/msda_win.py:637",
        "launches": main_launches,
        # over the checks at every serving size
        "max_abs_err": max(e["max_abs_err_fp32"] for pair in fwd_errs.values() for e in pair),
        "checked_at": [f"{h}x{w}" for h, w in fwd_errs],
        # one fp32 forward's work: 6 encoder calls + 6 decoder calls
        "ms": n_enc * enc_r["ms"] + n_dec * dec_r["ms"],
        "plain_ms": n_enc * enc_r["plain_ms"] + n_dec * dec_r["plain_ms"],
        "bound_ms": n_enc * enc_r["bound_ms"] + n_dec * dec_r["bound_ms"],
        "bound_by": enc_r["bound_by"],
        "library_ms": None,
        "per_call": per_call,
        "max_abs_err_bf16": max(e["max_abs_err_bf16"] for pair in fwd_errs.values() for e in pair),
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
        "card": stamp,
    }, {
        "name": "msda_bwd",
        "route": "cuda",
        "source": "codetr_torch/csrc/msda_bwd.cu",
        "replaces": "codetr_tpu/ops/msda_win_bwd.py:306",
        "launches": train["launches"]["msda_bwd"],  # over the 3 timed train steps
        "launches_per_step": n_enc + n_dec,
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
        "card": stamp,
    }, {
        "name": "gatherbench",
        "route": "cuda",
        "source": "codetr_torch/csrc/gatherbench.cu",
        "replaces": "tools/gatherbench.py:48",
        "launches": gbench["launches"],  # the sweep's
        "max_abs_err": max(gbench["errs"].values()),
        "checked_at": sorted(gbench["errs"]),
        # the whole sweep: one call of each case
        "ms": sum(r["ms"] for r in gbench["results"].values()),
        "plain_ms": sum(r["plain_ms"] for r in gbench["results"].values()),
        "bound_ms": sum(r["bound_ms"] for r in gbench["results"].values()),
        "bound_by": max(gbench["results"].values(), key=lambda r: r["bound_ms"])["bound_by"],
        # R one-plane PyTorch calls per case
        "library_ms": sum(r["library_us"] for r in gbench["results"].values()) * gbench["R"] / 1e3,
        "per_case": gbench["results"],
        "card": stamp,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
