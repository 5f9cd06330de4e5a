"""Checkpoint-day rehearsal: the port of the JAX package's
``tools/rehearsal.py``, one command over the whole chain from an mmdet
``.pth`` to scored detections on the card.

    python -m codetr_torch.tools.rehearsal [--height 608 --width 608]
        [--images 2] [--offset-scale 1.0] [--seed 0] [--pth FILE] [--out FILE]
        [--config swin-l] [--device cuda] [--dtype bfloat16] [--cpu-smoke]

1. the checkpoint: the writer is the port's own model (seeded, fp32, on the
   host through the plain PyTorch path, so the reader on the card is held
   against code that shares none of its kernels); its MSDA sampling-offset
   projections are drifted as training drifts them (``perturb_offsets``)
   and it is saved as ``{"state_dict", "meta"}`` to ``--out``, with
   ``meta.dataset_meta.classes`` and numpy values in the meta.  With
   ``--pth`` the writer is built from that file and nothing is written;
2. convert: the reader is ``build_codetr(cfg, pth)`` on ``--device`` in
   ``--dtype``, seeded differently from the writer; ``dataset_meta`` is
   read back;
3. the staged share, in place of the JAX calibration: the reader runs on a
   calibration batch drawn first from the rng (as in JAX, so the images
   match the JAX tool's), and each encoder layer's taps are counted under
   the tiled encoder kernel's plan (``ops/msda_tiles.staged_share``).  The
   JAX tool's (radius, budget) calibration and rebuild are n/a: the port's
   kernels are exact for every tap, so ``tier`` is "n/a: exact kernel";
4. the AP protocol: the writer's top-20 detections by score on each image
   are the ground truth, the reader's 300 the predictions, scored by
   ``utils/coco_eval.evaluate_detections`` (``ap_vs_writer``); beside it
   the rank-robust signal, each ground-truth box's best IoU among the
   predictions (``box_match_iou_p50`` / ``_min``), and per image the share
   of the writer's top-k encoder proposals that the reader's decoder
   started from too (``proposals_shared``) and at the same rank
   (``proposals_in_place``).  ``pass`` is
   ``box_match_iou_p50 >= 0.9`` (a bf16 reader flips the near-tied scores
   of an untrained model, so AP is reported, not gated).  The command
   exits 0 either way;
5. timing, on the card only: the reader's exported forward replayed as one
   CUDA graph between CUDA events (``runtime/aot.make_loop_timer``),
   ``--trials`` blocks of ``--iters`` replays, p50 / p95 / min.  The JAX
   tool's canary and sane window are n/a on a dedicated card.

It prints one JSON record.  ``--cpu-smoke`` is ``--config tiny --device cpu
--dtype float32``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List

import numpy as np
import torch

from codetr_torch.config import CONFIGS
from codetr_torch.models import msda_module
from codetr_torch.models.codetr import build_codetr, check_device, fp32_scope
from codetr_torch.ops import msda, msda_tiles
from codetr_torch.runtime.aot import DTYPES, compile_forward, make_loop_timer, percentile_stats
from codetr_torch.utils.checkpoint import _read, get_dataset_meta
from codetr_torch.utils.coco_eval import evaluate_detections

GT_PER_IMAGE = 20  # the writer's top detections taken as ground truth, as in JAX
PASS_IOU = 0.9  # the JAX rule on box_match_iou_p50
READER_SEED_OFFSET = 1  # the reader's init seed is the writer's plus this
EPOCH = 12  # the meta's numpy epoch


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--height", type=int, default=608)
    ap.add_argument("--width", type=int, default=608)
    ap.add_argument("--images", type=int, default=2)
    ap.add_argument("--offset-scale", type=float, default=1.0)
    ap.add_argument("--trials", type=int, default=6, help="timed blocks")
    ap.add_argument("--iters", type=int, default=3, help="graph replays a block")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pth", default=None,
                    help="use an existing .pth instead of writing one (the checkpoint-day invocation)")
    ap.add_argument("--out", default=None,
                    help="where the written .pth goes (default: rehearsal_ckpt.pth in the temporary directory)")
    ap.add_argument("--config", default="swin-l", choices=sorted(CONFIGS))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES), help="the reader's dtype")
    ap.add_argument("--cpu-smoke", action="store_true", help="--config tiny --device cpu --dtype float32")
    args = ap.parse_args(argv)
    if args.cpu_smoke:
        args.config, args.device, args.dtype = "tiny", "cpu", "float32"
    return args


def perturb_offsets(sd: Dict[str, np.ndarray], scale: float, seed: int) -> Dict[str, np.ndarray]:
    """Trained-like MSDA offset drift, in place, with the JAX tool's draws
    in its order: each ``sampling_offsets`` bias becomes ``v * scale`` plus
    N(0, 0.25 * scale) noise cast to its dtype first, each weight
    N(0, 0.3 * scale / sqrt(fan_in)) (zeros at init), encoder and decoder
    alike."""
    rng = np.random.default_rng(seed)
    n = 0
    for k in list(sd):
        if "sampling_offsets" not in k:
            continue
        v = sd[k]
        if k.endswith(".bias"):
            sd[k] = v * scale + rng.normal(0, 0.25 * scale, v.shape).astype(v.dtype)
        else:
            sd[k] = rng.normal(0, 0.3 * scale / max(1, v.shape[-1]) ** 0.5, v.shape).astype(v.dtype)
        n += 1
    assert n > 0, "no sampling_offsets keys found"
    return sd


@contextlib.contextmanager
def capture_encoder_taps(keep: int = 0):
    """Inside the scope, each call of the encoder's packed MSDA (one per
    encoder layer and forward) appends to the yielded list a dict with
    ``share``, (corner reads served from shared memory, all corner reads)
    of its taps under the tile plan the tiled kernel K1 runs them with
    (``msda_tiles.encoder_tile_plan`` for the value's dtype), and, for the
    first ``keep`` calls, ``taps`` = (value, spatial shapes, packed
    coordinates, points).  The module's function is restored on exit,
    also after an error."""
    calls: List[dict] = []
    packed = msda_module.msda_grid_packed

    def capture(value, spatial_shapes, cpk, num_points):
        plan = msda_tiles.encoder_tile_plan(spatial_shapes, value.dtype, head_dim=value.shape[3],
                                            points=num_points)
        call = {"share": msda_tiles.staged_share(
            plan, *msda._unpack(cpk, value.shape[2], len(spatial_shapes), num_points))}
        if len(calls) < keep:
            call["taps"] = (value.clone(), tuple(spatial_shapes), cpk.clone(), num_points)
        calls.append(call)
        return packed(value, spatial_shapes, cpk, num_points)

    msda_module.msda_grid_packed = capture
    try:
        yield calls
    finally:
        msda_module.msda_grid_packed = packed


def share_summary(calls: List[dict]) -> dict:
    """Per layer and overall staged share of ``capture_encoder_taps``' calls."""
    served, total = (sum(c["share"][i] for c in calls) for i in (0, 1))
    return {"per_layer": [c["share"][0] / c["share"][1] for c in calls],
            "overall": served / total, "corner_reads": [served, total]}


def draw_inputs(seed: int, height: int, width: int, images: int):
    """The JAX tool's draws from ``default_rng(seed)``, in its order: the
    calibration batch (1, H, W, 3), then each image (H, W, 3), all N(0, 1)
    x 0.5, float32, NHWC (the port's layout too)."""
    rng = np.random.default_rng(seed)
    cal_x = (rng.standard_normal((1, height, width, 3)) * 0.5).astype(np.float32)
    imgs = [(rng.standard_normal((height, width, 3)) * 0.5).astype(np.float32) for _ in range(images)]
    return cal_x, imgs


@torch.no_grad()
def detections(model, images, device) -> List[tuple]:
    """(boxes, scores, labels, proposals) numpy for each image, one forward
    each, no padding: the model's forward in its steps (features, the
    transformer, the top-k decode) in its precision scope; ``proposals``
    are the two-stage top-k encoder proposals the decoder started from."""
    head, out = model.query_head, []
    for im in images:
        x = torch.from_numpy(im[None]).to(device)
        mask = torch.zeros(1, *im.shape[:2], device=device)
        with fp32_scope(model.dtype):
            state, refs, aux = head.run_transformer(model.features(x), mask)
            dets = head.decode(state, refs, im.shape[:2])
        out.append(tuple(t[0].float().cpu().numpy() if t.is_floating_point() else t[0].cpu().numpy()
                         for t in (*dets, aux["topk_idx"])))
    return out


def proposals_shared(got: List[tuple], want: List[tuple]) -> List[float]:
    """Per image, the share of ``want``'s top-k proposals that ``got`` took too."""
    return [len(np.intersect1d(g[3], w[3])) / len(w[3]) for g, w in zip(got, want)]


def proposals_in_place(got: List[tuple], want: List[tuple]) -> List[float]:
    """Per image, the share of the top-k ranks at which ``got`` took the
    proposal ``want`` took: the decoder's query of rank i takes the
    content embedding i, so two near-tied proposals that swap ranks change
    the queries even where the set is the same."""
    return [float(np.mean(g[3] == w[3])) for g, w in zip(got, want)]


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes (the JAX tool's definition)."""
    ax1, ay1, ax2, ay2 = (a[:, i, None] for i in range(4))
    bx1, by1, bx2, by2 = (b[None, :, i] for i in range(4))
    iw = np.clip(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0, None)
    ih = np.clip(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0, None)
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / np.maximum(union, 1e-9)


def box_match_ious(gts: List[dict], preds: List[dict]) -> np.ndarray:
    """Each ground-truth box's best IoU among its image's predictions."""
    ious = [iou_matrix(g["boxes"], p["boxes"]).max(axis=1)
            for g, p in zip(gts, preds) if len(g["boxes"]) and len(p["boxes"])]
    return np.concatenate(ious) if ious else np.zeros(1)


def ground_truth(dets: List[tuple]) -> List[dict]:
    """The writer's top GT_PER_IMAGE detections by score (first index on ties)."""
    out = []
    for b, s, l, _ in dets:
        top = np.argsort(-s, kind="stable")[:GT_PER_IMAGE]
        out.append({"boxes": b[top], "labels": l[top]})
    return out


def jsonable(v):
    if isinstance(v, dict):
        return {str(k): jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [jsonable(x) for x in v]
    if isinstance(v, (np.generic, np.ndarray)):
        return v.tolist()
    return v


def write_checkpoint(cfg, path: str, scale: float, seed: int):
    """The writer (seeded, fp32, on the host) with drifted offsets, saved to
    ``path`` -> the writer."""
    writer = build_codetr(cfg, device="cpu", dtype=torch.float32, seed=seed)
    sd = perturb_offsets({k: v.numpy().copy() for k, v in writer.state_dict().items()}, scale, seed)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    writer.load_state_dict(tensors, strict=True)
    rng = np.random.default_rng(seed)
    n = cfg.head.num_classes
    torch.save({"state_dict": tensors,
                "meta": {"epoch": np.int64(EPOCH), "seed": np.int64(seed),
                         "dataset_meta": {"classes": ["obj%d" % i for i in range(n)],
                                          "palette": rng.integers(0, 256, (n, 3), np.uint8)}}},
               path)
    return writer


def loop_latency(model, image, dtype, trials: int, iters: int) -> dict:
    """The model's exported forward at the image's shape, replayed as one
    CUDA graph: ``trials`` blocks of ``iters`` replays between CUDA events."""
    h, w = image.shape[:2]
    device = next(model.parameters()).device
    fn, _ = compile_forward(model, height=h, width=w, dtype=dtype)
    args = (torch.from_numpy(image[None]).to(device, dtype), torch.zeros(1, h, w, device=device))
    run = make_loop_timer(fn, args, graph=True)
    run(iters)
    stats = percentile_stats([run(iters) for _ in range(trials)])
    return {"p50": stats["p50_ms"], "p95": stats["p95_ms"], "min": stats["min_ms"],
            "blocks_ms": stats["blocks_ms"], "replays_per_block": iters,
            "mode": "CUDA-graph replays of the exported forward, CUDA events"}


def rehearse(args: argparse.Namespace):
    """The rehearsal -> (record, detail): ``detail`` holds the images, the
    calibration batch and both sides' raw detections for callers that hold
    them to more."""
    device = check_device(args.device)
    dtype = DTYPES[args.dtype]
    cfg = CONFIGS[args.config]()
    H, W = args.height, args.width
    reader_seed = args.seed + READER_SEED_OFFSET
    record = {"height": H, "width": W, "offset_scale": args.offset_scale, "config": args.config,
              "device": str(device), "dtype": args.dtype, "images": args.images,
              "writer_seed": args.seed, "reader_seed": reader_seed}

    # 1. the checkpoint
    t0 = time.perf_counter()
    if args.pth is None:
        pth = args.out or os.path.join(tempfile.gettempdir(), "rehearsal_ckpt.pth")
        writer = write_checkpoint(cfg, pth, args.offset_scale, args.seed)
    else:
        pth = args.pth
        writer = build_codetr(cfg, pth, device="cpu", dtype=torch.float32, seed=args.seed)
    record["pth"], record["pth_written"] = pth, args.pth is None
    record["synthesize_s"] = time.perf_counter() - t0

    # 2. convert
    t0 = time.perf_counter()
    reader = build_codetr(cfg, pth, dtype=dtype, device=device, seed=reader_seed)
    record["convert_s"] = time.perf_counter() - t0
    record["dataset_meta"] = jsonable(get_dataset_meta(pth))
    # the meta's numbers as read back (numpy scalars and arrays stay numpy)
    record["meta_numbers"] = {k: {"type": type(v).__name__, "value": jsonable(v)}
                              for k, v in _read(pth).get("meta", {}).items()
                              if isinstance(v, (int, float, np.generic, np.ndarray))}

    # 3. the staged share of the reader's own encoder taps (the calibration is n/a)
    t0 = time.perf_counter()
    cal_x, imgs = draw_inputs(args.seed, H, W, args.images)
    with capture_encoder_taps() as calls:
        detections(reader, list(cal_x), device)
    if len(calls) != cfg.head.transformer.num_encoder_layers:
        raise RuntimeError(f"captured {len(calls)} encoder MSDA calls, not one per encoder layer")
    record["staged_share"] = share_summary(calls)
    record["calibrate_s"] = time.perf_counter() - t0
    record["tier"] = "n/a: exact kernel"

    # 4. the AP protocol: the writer's detections are the ground truth
    t0 = time.perf_counter()
    writer_dets = detections(writer, imgs, torch.device("cpu"))
    msda.launches = msda.launches_qm = msda.launches_bwd = 0
    reader_dets = detections(reader, imgs, device)
    launches = (msda.launches, msda.launches_qm, msda.launches_bwd)
    gts = ground_truth(writer_dets)
    preds = [{"boxes": b, "scores": s, "labels": l} for b, s, l, _ in reader_dets]
    record["ap_vs_writer"] = evaluate_detections(preds, gts, cfg.head.num_classes)
    ious = box_match_ious(gts, preds)
    record["box_match_iou_p50"] = float(np.median(ious))
    record["box_match_iou_min"] = float(ious.min())
    record["proposals_shared"] = proposals_shared(reader_dets, writer_dets)
    record["proposals_in_place"] = proposals_in_place(reader_dets, writer_dets)
    record["msda_launches"] = {"forward": launches[0], "q_minor": launches[1], "backward": launches[2],
                               "per_forward": launches[0] / max(1, len(imgs))}
    record["serve_s"] = time.perf_counter() - t0

    # 5. timing, on the card only
    record["latency_ms"] = None
    if device.type == "cuda":
        t0 = time.perf_counter()
        record["latency_ms"] = loop_latency(reader, imgs[0], dtype, args.trials, args.iters)
        record["time_s"] = time.perf_counter() - t0
        record["card"] = torch.cuda.get_device_name(device)
    record["pass"] = bool(record["box_match_iou_p50"] >= PASS_IOU)
    detail = {"cfg": cfg, "images": imgs, "cal_x": cal_x, "writer": writer_dets, "reader": reader_dets,
              "ground_truth": gts, "pth": pth, "reader_seed": reader_seed}
    return record, detail


def main(argv=None) -> dict:
    record, _ = rehearse(parse_args(argv))
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
