"""COCO-style detection mAP evaluation (numpy, dependency-free): a copy of
the JAX package's ``utils/coco_eval.py``, its constants and functions
unchanged.

The reference defers evaluation to mmdet's COCO metric (config
val_evaluator=dict(metric='bbox'), co_dino_5scale_r50_lsj:331); pycocotools
is not a dependency, so the COCOeval bbox protocol is re-implemented here
faithfully:

- greedy per-(image, category) matching in descending score order, each
  detection taking the highest-IoU untaken ground truth >= threshold, with
  the exact pycocotools tie rules (a real gt is preferred over an ignored
  one; crowd gts may be matched by multiple detections);
- ignore semantics: iscrowd gts and gts outside the area range are ignored —
  detections matched to them are dropped from both TP and FP, unmatched
  detections outside the area range are dropped from FP;
- crowd IoU = intersection / detection area (pycocotools iscrowd flag);
- per-(image, category) maxDets truncation (100);
- 101-point interpolated precision envelope, AP over IoU 0.50:0.95:0.05,
  area ranges all/small/medium/large, AR@100.

Deliberate deviation from pycocotools: category averaging skips classes with
zero ground truth (identical to COCOeval's nan handling).

It stays host numpy in float64, as in the JAX package, and is not written
in torch ops: the protocol is a greedy, sequential match per (image,
class, threshold), and its ties are decided by numpy's stable argsorts.  A
torch version would run the same loop on the host, gain nothing, and could
order ties differently.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 100


def box_iou(a: np.ndarray, b: np.ndarray, iscrowd: np.ndarray | None = None) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU; crowd columns use inter/det_area
    (pycocotools maskUtils.iou iscrowd semantics)."""
    area_a = np.maximum(a[:, 2] - a[:, 0], 0) * np.maximum(a[:, 3] - a[:, 1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(b[:, 3] - b[:, 1], 0)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None, :] - inter
    if iscrowd is not None and iscrowd.any():
        union = np.where(iscrowd[None, :], area_a[:, None], union)
    return np.where(union > 0, inter / union, 0.0)


def _evaluate_img(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    gt_iscrowd: np.ndarray,
    gt_areas: np.ndarray,
    area_rng: Tuple[float, float],
    max_det: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """pycocotools COCOeval.evaluateImg for one (image, category, areaRng).

    Returns (scores (D,), dt_matched (T,D) bool, dt_ignored (T,D) bool,
    n_non_ignored_gt)."""
    T = len(IOU_THRESHOLDS)
    gt_ig = gt_iscrowd | (gt_areas < area_rng[0]) | (gt_areas > area_rng[1])
    # gts sorted: non-ignored first (stable)
    g_order = np.argsort(gt_ig, kind="stable")
    gt_boxes = gt_boxes[g_order]
    gt_ig = gt_ig[g_order]
    crowd = gt_iscrowd[g_order]

    d_order = np.argsort(-det_scores, kind="stable")[:max_det]
    det_boxes = det_boxes[d_order]
    det_scores = det_scores[d_order]
    D, G = len(det_boxes), len(gt_boxes)

    dtm = np.zeros((T, D), np.int64) - 1
    dt_ig = np.zeros((T, D), bool)
    if G:
        ious = box_iou(det_boxes, gt_boxes, crowd)
        for ti, thr in enumerate(IOU_THRESHOLDS):
            gtm = np.zeros(G, bool)
            for di in range(D):
                best = thr - 1e-10
                m = -1
                for gi in range(G):
                    # taken, and not a crowd (crowds can absorb many dets)
                    if gtm[gi] and not crowd[gi]:
                        continue
                    # real match already found; remaining gts are ignored
                    if m > -1 and not gt_ig[m] and gt_ig[gi]:
                        break
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m >= 0:
                    dtm[ti, di] = m
                    gtm[m] = True
                    dt_ig[ti, di] = gt_ig[m]
    # unmatched detections outside the area range are ignored, not FPs
    d_areas = np.maximum(det_boxes[:, 2] - det_boxes[:, 0], 0) * np.maximum(
        det_boxes[:, 3] - det_boxes[:, 1], 0
    )
    outside = (d_areas < area_rng[0]) | (d_areas > area_rng[1])
    dt_ig = dt_ig | ((dtm < 0) & outside[None, :])
    return det_scores, dtm >= 0, dt_ig, int((~gt_ig).sum())


def average_precision(scores, tp, ignored, n_gt) -> Tuple[float, float]:
    """(101-point AP, best recall) for one (class, iou_thr, area_rng)."""
    if n_gt == 0:
        return np.nan, np.nan
    order = np.argsort(-scores, kind="stable")
    tp = tp[order]
    ig = ignored[order]
    tp = tp[~ig]
    if len(tp) == 0:
        return 0.0, 0.0
    ctp = np.cumsum(tp)
    cfp = np.cumsum(~tp)
    recall = ctp / n_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-9)
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    prec_at = np.where(
        idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0
    )
    prec_at[idx >= len(precision)] = 0.0
    rec_best = float(recall[-1]) if len(recall) else 0.0
    return float(prec_at.mean()), rec_best


def evaluate_detections(
    predictions: Sequence[dict],
    ground_truths: Sequence[dict],
    num_classes: int,
) -> Dict[str, float]:
    """predictions/ground_truths: per image dicts with 'boxes' (N,4) xyxy,
    'labels' (N,); predictions add 'scores' (N,); ground truths may add
    'iscrowd' (N,) bool and 'areas' (N,) (COCO annotation areas — falls back
    to box areas).

    Returns COCO-protocol metrics: mAP, mAP_50, mAP_75, mAP_small/medium/
    large, AR_100."""
    assert len(predictions) == len(ground_truths)
    T = len(IOU_THRESHOLDS)
    names = list(AREA_RANGES)
    ap = np.full((len(names), T, num_classes), np.nan)
    ar = np.full((T, num_classes), np.nan)

    for ci in range(num_classes):
        per_img = []
        for pred, gt in zip(predictions, ground_truths):
            pm = np.asarray(pred["labels"]) == ci
            gm = np.asarray(gt["labels"]) == ci
            gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[gm]
            crowd = np.asarray(
                gt.get("iscrowd", np.zeros(len(gm), bool))
            ).astype(bool)[gm]
            if "areas" in gt:
                areas = np.asarray(gt["areas"], np.float64)[gm]
            else:
                areas = np.maximum(gt_boxes[:, 2] - gt_boxes[:, 0], 0) * np.maximum(
                    gt_boxes[:, 3] - gt_boxes[:, 1], 0
                )
            per_img.append(
                (
                    np.asarray(pred["boxes"], np.float64).reshape(-1, 4)[pm],
                    np.asarray(pred["scores"], np.float64)[pm],
                    gt_boxes,
                    crowd,
                    areas,
                )
            )
        for ai, aname in enumerate(names):
            rng = AREA_RANGES[aname]
            scores_l: List[np.ndarray] = []
            tp_l: List[np.ndarray] = []
            ig_l: List[np.ndarray] = []
            n_gt = 0
            for db, ds, gb, cr, ga in per_img:
                s, tpm, ig, ng = _evaluate_img(db, ds, gb, cr, ga, rng, MAX_DETS)
                scores_l.append(s)
                tp_l.append(tpm)
                ig_l.append(ig)
                n_gt += ng
            if n_gt == 0:
                continue
            scores = np.concatenate(scores_l) if scores_l else np.zeros(0)
            for ti in range(T):
                tps = (
                    np.concatenate([t[ti] for t in tp_l]) if tp_l else np.zeros(0, bool)
                )
                igs = (
                    np.concatenate([g[ti] for g in ig_l]) if ig_l else np.zeros(0, bool)
                )
                a, r = average_precision(scores, tps, igs, n_gt)
                ap[ai, ti, ci] = a
                if aname == "all":
                    ar[ti, ci] = r

    def nm(x):
        return float(np.nanmean(x)) if np.isfinite(x).any() else 0.0

    return {
        "mAP": nm(ap[0]),
        "mAP_50": nm(ap[0, 0]),
        "mAP_75": nm(ap[0, 5]),
        "mAP_small": nm(ap[1]),
        "mAP_medium": nm(ap[2]),
        "mAP_large": nm(ap[3]),
        "AR_100": nm(ar),
    }


def load_coco_annotations(json_path: str) -> Dict[int, dict]:
    """COCO instances json -> {image_id: {'file_name', 'boxes', 'labels',
    'iscrowd', 'areas'}}.  Category ids are densified to contiguous [0, C) in
    COCO order.  Crowd annotations are KEPT (they carry ignore semantics in
    the COCOeval protocol)."""
    import json

    with open(json_path) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco["categories"])
    cat_map = {cid: i for i, cid in enumerate(cat_ids)}
    images = {
        im["id"]: {
            "file_name": im["file_name"],
            "boxes": [],
            "labels": [],
            "iscrowd": [],
            "areas": [],
        }
        for im in coco["images"]
    }
    for ann in coco.get("annotations", []):
        x, y, w, h = ann["bbox"]
        img = images[ann["image_id"]]
        img["boxes"].append([x, y, x + w, y + h])
        img["labels"].append(cat_map[ann["category_id"]])
        img["iscrowd"].append(bool(ann.get("iscrowd", 0)))
        img["areas"].append(float(ann.get("area", w * h)))
    for im in images.values():
        im["boxes"] = np.asarray(im["boxes"], np.float64).reshape(-1, 4)
        im["labels"] = np.asarray(im["labels"], np.int64)
        im["iscrowd"] = np.asarray(im["iscrowd"], bool)
        im["areas"] = np.asarray(im["areas"], np.float64)
    return images
