"""COCO evaluation CLI, the counterpart of the JAX package's root
``eval_coco.py`` (batched, padded static shapes):

    python -m codetr_torch.eval_coco --ann instances_val2017.json --img-dir val2017/ \\
        --config swin-l --height 768 --width 1152 --dtype bfloat16 --batch-size 4

The flags and their defaults are the JAX script's, plus ``--device`` (the
card unless ``--device cpu``).  Each image the annotations list is read
(an ``.npy`` (H, W, 3) uint8 RGB array, or through cv2 any file it reads),
served through the ``Inferencer`` (preprocess, forward, (soft-)NMS and the
rescale to original-image pixels, all on the device; a short last batch is
padded by repeating an image, where the JAX script pads with zeros, and the
real images' results do not depend on it), and the kept detections are
scored by ``utils.coco_eval.evaluate_detections``.  Prints a progress line,
the metrics as JSON (the JAX script's keys) and, on a line of its own, the
seconds spent reading, serving and scoring.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from codetr_torch.config import CONFIGS
from codetr_torch.inferencer import Inferencer
from codetr_torch.models.codetr import build_codetr, check_device
from codetr_torch.runtime.aot import DTYPES
from codetr_torch.utils.coco_eval import evaluate_detections, load_coco_annotations
from codetr_torch.utils.image_io import read_image

BATCHES_PER_CHUNK = 8  # images read per serving call: bounds host memory, keeps batches queued


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="COCO bbox evaluation of Co-DINO")
    ap.add_argument("--ann", required=True, help="COCO instances json")
    ap.add_argument("--img-dir", required=True)
    ap.add_argument("--config", default="swin-l", choices=["swin-l", "r50", "tiny"])
    ap.add_argument("--weights", default=None, help="mmdet .pth checkpoint")
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=1152)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--score-threshold", type=float, default=0.0)
    ap.add_argument("--iou-threshold", type=float, default=0.8)
    ap.add_argument("--nms-type", default=None,
                    choices=[None, "nms", "soft_nms", "soft_nms_gaussian"],
                    help="default: the config's test_cfg NMS (soft_nms)")
    ap.add_argument("--max-images", type=int, default=None)
    ap.add_argument("--msda-impl", default="auto")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def predict(inferencer: Inferencer, paths: Sequence[str], timings: Optional[Dict[str, float]] = None,
            progress: bool = False) -> List[dict]:
    """Per image, the kept detections in original-image pixels: ``boxes``
    (N, 4) xyxy, ``scores`` (N,), ``labels`` (N,), as the JAX script builds
    them.  ``timings`` (if given) gains ``read_s`` and ``serve_s``, host
    seconds; the serving time ends when the results are on the host."""
    chunk = inferencer.batch_size * BATCHES_PER_CHUNK
    read_s = serve_s = 0.0
    preds: List[dict] = []
    for i0 in range(0, len(paths), chunk):
        t0 = time.perf_counter()
        images = [read_image(p) for p in paths[i0:i0 + chunk]]
        t1 = time.perf_counter()
        dets = inferencer(images)
        t2 = time.perf_counter()
        read_s += t1 - t0
        serve_s += t2 - t1
        preds.extend({"boxes": d.boxes[d.keep], "scores": d.scores[d.keep], "labels": d.labels[d.keep]}
                     for d in dets)
        if progress:
            print(f"\r{len(preds)}/{len(paths)}", end="", flush=True)
    if progress:
        print()
    if timings is not None:
        timings.update(read_s=read_s, serve_s=serve_s)
    return preds


def main(argv=None, timings: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """Runs the CLI; returns the metrics.  ``timings`` (if given) gains
    ``read_s``, ``serve_s`` and ``evaluate_s``."""
    args = parse_args(argv)
    device = check_device(args.device)
    cfg = CONFIGS[args.config]()
    dtype = DTYPES[args.dtype]
    model = build_codetr(cfg, args.weights, dtype=dtype, device=device, msda_impl=args.msda_impl)
    inferencer = Inferencer(model, height=args.height, width=args.width, batch_size=args.batch_size,
                            score_threshold=args.score_threshold, iou_threshold=args.iou_threshold,
                            nms_type=args.nms_type, device=device)

    images = load_coco_annotations(args.ann)
    ids = sorted(images)[: args.max_images]
    paths = [os.path.join(args.img_dir, images[i]["file_name"]) for i in ids]
    timings = {} if timings is None else timings
    preds = predict(inferencer, paths, timings, progress=True)
    t0 = time.perf_counter()
    metrics = evaluate_detections(preds, [images[i] for i in ids], cfg.head.num_classes)
    timings["evaluate_s"] = time.perf_counter() - t0
    print(json.dumps(metrics, indent=2))
    print(json.dumps({"images": len(ids), "seconds": {
        "read": timings["read_s"], "serve": timings["serve_s"], "evaluate": timings["evaluate_s"]}}))
    return metrics


if __name__ == "__main__":
    main()
