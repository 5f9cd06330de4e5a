#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check every part of it.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero without a result):
1. identify the card (nvidia-smi name and power limit, torch/CUDA versions);
2. build the CUDA kernels from ``codetr_torch/csrc`` (build seconds and
   ``-Xptxas -v`` printed);
3. hold the MSDA kernel against its plain PyTorch version at the 768x1152
   main-path shapes (encoder: 5 levels, K = 73,656 queries; decoder: 900
   queries with 4-coordinate references), value in fp32 and in bf16;
4. check the full-width Swin-L model on the card against the same model run
   on the CPU through the plain version, at a small input;
5. serve 3 synthetic images of different sizes through the Swin-L
   ``Inferencer`` at 768x1152 in fp32 and one in bf16, checking the outputs
   and that each forward launched the kernel 12 times (6 encoder + 6 decoder
   layers);
6. time the kernel, its plain version and the end-to-end latency, and print
   them beside the card's name and power limit, then the ``kernels`` line
   and, last, the result line.

All comparisons run with TF32 off (``allow_tf32 = False`` for matmul and
cuDNN), so fp32 means fp32 on both sides; the latency figures are therefore
full-fp32 figures too.
"""

from __future__ import annotations

import copy
import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from codetr_torch import Inferencer, build_codetr, co_dino_swin_l
from codetr_torch.ops import _build
from codetr_torch.ops import msda

HEIGHT, WIDTH = 768, 1152  # the serving size
CHECK_HW = (384, 384)  # small input for the card-vs-CPU model check
SEED = 0
DEVICE = "cuda"
CONFIG = co_dino_swin_l
# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s, fp32
# FLOP/s outside the tensor cores (the kernel's FMAs run on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def fail(msg: str) -> None:
    raise RuntimeError(msg)


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


def bound_ms(value, shapes, loc, w, out_dtype):
    """Least time for the work: bytes (each value row the taps really touch,
    the coordinates and weights, the output; each once) over HBM rate, and
    the FMAs over the fp32 rate; the larger of the two."""
    bs, K, h, d = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
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
    n_rows = torch.unique(torch.cat(rows)).numel()
    nbytes = (
        n_rows * d * value.element_size()
        + loc.numel() * 4 + w.numel() * 4
        + bs * Q * h * d * torch.empty((), dtype=out_dtype).element_size()
    )
    flops = bs * Q * h * L * P * 4 * d * 2
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


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

    # 2. build
    built = _build.load("msda_fwd")
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

    # 4. the whole model on the card against the CPU reference
    cfg = CONFIG()
    compare_models(cfg, CHECK_HW, stamp)

    # 5. the main path: Swin-L Inferencer at 768x1152
    rng = np.random.default_rng(SEED)
    images = [rng.integers(0, 256, s, np.uint8) for s in ((480, 640, 3), (1280, 720, 3), (900, 1600, 3))]
    model = build_codetr(cfg, device=DEVICE, seed=SEED)
    inf = Inferencer(model, height=HEIGHT, width=WIDTH, batch_size=1, device=DEVICE)
    inf(images[:1])  # warm-up: library handles, allocator, cached masks
    torch.cuda.synchronize()
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

    # 6. timings
    per_call = {}
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
    for i, t in enumerate(latencies):
        print(f"latency fp32 image {i} {images[i].shape[:2]}: {t:.2f} ms [{stamp}]")
    print(f"latency fp32 median: {statistics.median(latencies):.2f} ms per image [{stamp}]")
    print(f"latency bf16 image 1: {lat_bf16:.2f} ms [{stamp}]")
    print(f"fp32 split, one image: preprocess {t_pre:.2f} ms, backbone+neck {t_feat:.2f} ms, "
          f"head {t_det:.2f} ms, soft-NMS {t_post:.2f} ms [{stamp}]")
    print(f"peak memory allocated, fp32 main path: {peak_mem / 2**30:.3f} GiB [{stamp}]")

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
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
