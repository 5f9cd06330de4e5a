"""Ground truth for the evaluation tests, shared by the CPU tests
(``test_torch_port_eval.py``) and the card's (``test_torch_port_cuda.py``):
COCO annotations built from one run's detections so that another run's
legitimate differences cannot change the metrics.  numpy and the port's
``coco_eval`` only, so the card's tests import it without JAX."""

import itertools
import json
from pathlib import Path

import numpy as np

from codetr_torch.utils import coco_eval

# 5 images larger than the tests' 128x128 canvas: a box in original pixels
# is 2.5-7.8x the model's, so the ladder's 0.1 px is small against the
# boxes the ground truth is built from
EVAL_SIZES = ((480, 640), (640, 400), (1000, 1500), (305, 485), (750, 500))
BOX_TOL = 0.1  # the ladder's boxes, px


def iou_bounds(a, b, tol=BOX_TOL):
    """The least and the most IoU of box ``a`` with box ``b`` when each of
    ``b``'s coordinates moves by up to ``tol`` (over the 81 corner moves)."""
    ious = [coco_eval.box_iou(a[None], (b + np.array(m))[None])[0, 0]
            for m in itertools.product((-tol, 0.0, tol), repeat=4)]
    return min(ious), max(ious)


THRESHOLDS = coco_eval.IOU_THRESHOLDS
# each target IoU halfway between two thresholds (or above the last)
TARGETS = np.concatenate([(THRESHOLDS[:-1] + THRESHOLDS[1:]) / 2, [0.975]])


def ground_truth(preds):
    """COCO annotations built from one run's detections so that no
    legitimate difference from another run (the JAX package's, or the
    card's against the CPU's: scores 2e-4, boxes 0.1 px) can change a match
    or a rank, by construction:

    - a gt is made only for a detection whose score is at least 1e-3 from
      every other detection of its class, in any image (its rank among
      them cannot change);
    - the gt is the detection's box with its width cut to the target IoU,
      each target halfway between two IoU thresholds (or above the last),
      and is kept only if, with the detection moved by up to 0.1 px in each
      coordinate, its IoU stays between the same two thresholds, and its
      IoU with every other detection of the class in the image, moved so,
      stays below the first threshold (no other detection can take it);
    - no detection's area lies within a 0.1 px move of an area-range bound
      (an unmatched detection's ignore flag cannot change); checked, not
      chosen: the images' seed gives such detections, and the check says
      if it stops doing so.

    Returns the annotations and the number of gts made."""
    for p in preds:
        for b in p["boxes"]:
            w, h = b[2] - b[0], b[3] - b[1]
            for bound in (32.0**2, 96.0**2):
                assert abs(w * h - bound) > 2 * BOX_TOL * (w + h) + 4 * BOX_TOL**2, (b, bound)
    anns, made = [], 0
    for img, p in enumerate(preds):
        for j in np.argsort(-p["scores"], kind="stable"):
            box, label, score = p["boxes"][j], p["labels"][j], p["scores"][j]
            others = np.concatenate([q["scores"][q["labels"] == label] for q in preds])
            if np.sum(np.abs(others - score) < 1e-3) > 1:
                continue
            target = TARGETS[made % len(TARGETS)]
            g = np.array([box[0], box[1], box[0] + target * (box[2] - box[0]), box[3]])
            lo, hi = iou_bounds(g, box)
            k = np.searchsorted(THRESHOLDS, target)
            if not ((k == 0 or lo > THRESHOLDS[k - 1]) and (k == len(THRESHOLDS) or hi < THRESHOLDS[k])):
                continue
            rivals = [b for i, b in enumerate(p["boxes"]) if p["labels"][i] == label and i != j]
            if any(iou_bounds(g, b)[1] >= THRESHOLDS[0] for b in rivals):
                continue
            anns.append({"id": len(anns) + 1, "image_id": img + 1, "category_id": int(label) * 2 + 1,
                         "bbox": [float(g[0]), float(g[1]), float(g[2] - g[0]), float(g[3] - g[1])],
                         "area": float((g[2] - g[0]) * (g[3] - g[1])), "iscrowd": 0})
            made += 1
    # a gt that no detection reaches, so recall stays below 1
    anns.append({"id": len(anns) + 1, "image_id": 1, "category_id": 1, "bbox": [0.0, 0.0, 3.0, 3.0],
                 "area": 9.0, "iscrowd": 0})
    return anns, made


def write_annotations(path, names, suffix, anns):
    """A COCO instances file over ``names``: odd category ids (1, 3, ...,
    13), densified back to the tiny model's labels 0..6."""
    images = [{"id": i + 1, "file_name": n + suffix} for i, n in enumerate(names)]
    cats = [{"id": 2 * c + 1, "name": f"c{c}"} for c in range(7)]
    Path(path).write_text(json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return str(path)
