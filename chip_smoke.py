#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every part of it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a result):
1. identify the card (nvidia-smi name and power limit, torch/CUDA versions);
2. build the CUDA kernels from ``codetr_torch/csrc``, one nvcc each, all at
   once (build seconds and ``-Xptxas -v`` printed);
3. hold the MSDA forward and backward kernels against their plain PyTorch
   versions at the 768x1152 main-path shapes (encoder: 5 levels, K = 73,656
   queries, packed layout; decoder: 900 queries with 4-coordinate
   references), value in fp32 and in bf16;
4. check the full-width Swin-L model's inference forward on the card
   against the same model run on the CPU through the plain versions, at a
   small input;
5. the serving path: 3 synthetic images of different sizes through the
   Swin-L ``Inferencer`` at 768x1152 in fp32 and one in bf16, checking the
   outputs and that each forward launched the forward kernel 12 times (6
   encoder + 6 decoder layers);
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

from codetr_torch import Inferencer, build_codetr, co_dino_swin_l
from codetr_torch.ops import _build
from codetr_torch.ops import msda
from codetr_torch.parallel.losses import dino_detection_loss
from codetr_torch.parallel.train import adamw, make_train_step

HEIGHT, WIDTH = 768, 1152  # the serving size
CHECK_HW = (384, 384)  # small input for the card-vs-CPU model check
TRAIN_CHECK_HW = (256, 256)  # small input for the card-vs-CPU train-step check (K = 5,456)
PERTURBATIONS = 3  # seeded 1e-7 weight perturbations that measure each gradient's spread
CP_BATCH = 6  # a train batch whose step does not fit the card without SwinConfig.with_cp
KERNELS = ("msda_fwd", "msda_bwd")
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


def upstream_grads(num_keys):
    """Seeded upstream gradients (1, Q, 256) of the encoder (Q = K) and
    decoder (Q = 900) calls."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    return (torch.randn(1, num_keys, 256, generator=gen, device=DEVICE),
            torch.randn(1, 900, 256, generator=gen, device=DEVICE))


def plain_backward(value, shapes, loc, w, grad_out):
    return msda.msda_backward_plain(value, shapes, loc[..., 0], loc[..., 1], w, grad_out)


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
    MSDA layer and give a finite loss."""
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

    res = {}
    if split:
        res.update(predict_ms=host_ms(predict), fwd_ms=host_ms(fwd), fwd_bwd_ms=host_ms(fwd_bwd))
    step(x, mask, *targets)  # warm-up step: the optimizer's state
    torch.cuda.synchronize()
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
    res.update(step_ms=step_ms, losses=losses, peak_bytes=peak, launches=launches)
    return res


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


def compare_models(cfg, shape_hw, stamp):
    """The Swin-L model on the card (kernel path) against the same weights on
    the CPU (plain path), fp32, at a small padded input."""
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
    print(f"Swin-L {h}x{w} card vs CPU: features rel err {feat_err:.3e}, encoder memory "
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

    # 3. kernel vs plain at the main path's shapes
    shapes = level_shapes(HEIGHT, WIDTH)
    K = sum(h * w for h, w in shapes)
    print(f"levels at {HEIGHT}x{WIDTH}: {shapes}, K = {K}")
    P = 4
    value, loc_e, w_e = msda_inputs(shapes, K)
    cpk = pack(loc_e, w_e)
    _, loc_d, w_d = msda_inputs(shapes, 900, decoder=True)
    enc = check_kernel(
        f"encoder MSDA (packed, Q={K})", value,
        lambda v: msda.msda_grid_packed(v, shapes, cpk, P),
        lambda v: msda.msda_grid_packed_plain(v, shapes, cpk, P), stamp,
    )
    dec = check_kernel(
        "decoder MSDA (reference layout, Q=900)", value,
        lambda v: msda.multi_scale_deformable_attention(v, shapes, loc_d, w_d),
        lambda v: msda.multi_scale_deformable_attention_plain(v, shapes, loc_d, w_d), stamp,
    )

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
    del g_e, g_d

    # 4. the whole model's inference forward on the card against the CPU
    # reference (the train step's check follows the serving path, so that
    # its buffers do not count in the serving path's peak memory)
    cfg = CONFIG()
    compare_models(cfg, CHECK_HW, stamp)

    # 5. the main path: Swin-L Inferencer at 768x1152
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, s, np.uint8) for s in ((480, 640, 3), (1280, 720, 3), (900, 1600, 3))]
    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    inf = Inferencer(model, height=HEIGHT, width=WIDTH, batch_size=1, device=DEVICE)
    inf(images[:1])  # warm-up: library handles, allocator, cached masks
    torch.cuda.synchronize()
    held_before_serving = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    msda.launches = 0
    dets, latencies = [], []
    for im in images:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dets += inf([im])
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    main_launches = msda.launches
    peak_mem = torch.cuda.max_memory_allocated()
    check_detections(dets, 3, cfg.head.max_per_img)
    per_forward = launches_per_forward(cfg)  # 6 encoder + 6 decoder layers for Swin-L
    if main_launches != per_forward * len(images):
        fail(f"main path launched the kernel {main_launches} times, not {per_forward * len(images)}")
    print(f"main path fp32: {len(images)} images, kernel launches {main_launches} "
          f"({per_forward} per forward), kept detections {[int(d.keep.sum()) for d in dets]}")

    # where a forward's time goes, measured piece by piece on one image
    from codetr_torch.ops.nms import postprocess_detections
    from codetr_torch.utils.preprocess import preprocess

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, (time.perf_counter() - t0) * 1e3

    with torch.inference_mode():
        pre, t_pre = timed(lambda: preprocess(images[2], HEIGHT, WIDTH, cfg.preprocess, device=DEVICE))
        x, mk = pre[0][None], pre[1][None]
        feats, t_feat = timed(lambda: model.features(x))
        det, t_det = timed(lambda: model.detect(feats, mk))
        _, t_post = timed(lambda: postprocess_detections(
            *det, score_threshold=0.0, iou_threshold=cfg.head.nms_iou_threshold,
            nms_type=cfg.head.nms_type))
    del model, inf, feats, det
    torch.cuda.empty_cache()

    model_bf16 = build_codetr(cfg, dtype=torch.bfloat16, device=DEVICE, seed=SEED)
    inf_bf16 = Inferencer(model_bf16, height=HEIGHT, width=WIDTH, batch_size=1, device=DEVICE)
    inf_bf16(images[:1])
    msda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dets_bf16 = inf_bf16(images[1:2])
    torch.cuda.synchronize()
    lat_bf16 = (time.perf_counter() - t0) * 1e3
    bf16_launches = msda.launches
    check_detections(dets_bf16, 1, cfg.head.max_per_img)
    if bf16_launches != per_forward:
        fail(f"bf16 forward launched the kernel {bf16_launches} times, not {per_forward}")
    del model_bf16, inf_bf16
    torch.cuda.empty_cache()

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
    g_e, g_d = upstream_grads(K)
    for name, v_dtype in (("encoder", torch.float32), ("encoder_bf16", torch.bfloat16),
                          ("decoder", torch.float32), ("decoder_bf16", torch.bfloat16)):
        v = value.to(v_dtype)
        if name.startswith("encoder"):
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
    for i, t in enumerate(latencies):
        print(f"latency fp32 image {i} {images[i].shape[:2]}: {t:.2f} ms [{stamp}]")
    print(f"latency fp32 median: {statistics.median(latencies):.2f} ms per image [{stamp}]")
    print(f"latency bf16 image 1: {lat_bf16:.2f} ms [{stamp}]")
    print(f"fp32 split, one image: preprocess {t_pre:.2f} ms, backbone+neck {t_feat:.2f} ms, "
          f"head {t_det:.2f} ms, soft-NMS {t_post:.2f} ms [{stamp}]")
    print(f"peak memory allocated, fp32 main path: {peak_mem / 2**30:.3f} GiB, of which "
          f"{held_before_serving / 2**30:.3f} GiB held before the serving path [{stamp}]")
    print(f"train fp32 {HEIGHT}x{WIDTH} batch 1: predictions (train_outputs) "
          f"{fmt_ms(train['predict_ms'])}, loss forward {fmt_ms(train['fwd_ms'])}, "
          f"forward+backward {fmt_ms(train['fwd_bwd_ms'])}, step {fmt_ms(train['step_ms'])} ms; "
          f"peak memory allocated over the steps {train['peak_bytes'] / 2**30:.3f} GiB; "
          f"losses {train['losses']} [{stamp}]")
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"train fp32 {HEIGHT}x{WIDTH} with_cp, batch 1: step {fmt_ms(train_cp['step_ms'])} ms, "
          f"peak {train_cp['peak_bytes'] / 2**30:.3f} GiB; batch {CP_BATCH}: step "
          f"{fmt_ms(train_cp_big['step_ms'])} ms, peak {train_cp_big['peak_bytes'] / 2**30:.3f} "
          f"GiB, losses {train_cp_big['losses']}; batch {CP_BATCH} without with_cp, forward+"
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
        "max_abs_err": max(enc["max_abs_err_fp32"], dec["max_abs_err_fp32"]),
        # one fp32 forward's work: 6 encoder calls + 6 decoder calls
        "ms": n_enc * enc_r["ms"] + n_dec * dec_r["ms"],
        "plain_ms": n_enc * enc_r["plain_ms"] + n_dec * dec_r["plain_ms"],
        "bound_ms": n_enc * enc_r["bound_ms"] + n_dec * dec_r["bound_ms"],
        "bound_by": enc_r["bound_by"],
        "library_ms": None,
        "per_call": per_call,
        "max_abs_err_bf16": max(enc["max_abs_err_bf16"], dec["max_abs_err_bf16"]),
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
        "card": stamp,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
