"""The comparison that decides ``correct``: what the timed path served,
judged by the float32 reference on the same images and weights.

Two stages are judged apart, because the model's random weights make its
detections chaotic (PERF.md, "How correct is decided"):

- the forward, image -> the head's top detections before NMS (``fwd.*``):
  the program's, as the Inferencer's forward returned them in the window,
  against the reference's own preprocess and forward of the same image;
- the postprocess, those detections -> the served ``Detections``
  (``post.*``): the served result against the reference's soft-NMS and
  rescale run on the program's own pre-NMS detections, with the
  reference's own scale factor.

``reference_view(...)`` runs the reference on one image and
``image_readings(...)`` gives that image's numbers; a run's number is the
largest over the images it checks, and each is held to its limit in
``perfbench/limits/<cell>.json``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.reference import pipeline

MATCH_IOU = 0.5


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n, 4) x (m, 4) xyxy -> (n, m) IoU."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa: E731
    union = area(a)[:, None] + area(b)[None] - inter
    same = (a[:, None, :] == b[None, :, :]).all(-1)  # equal boxes match, even of zero area
    return np.where(union > 0, inter / np.where(union > 0, union, 1), same.astype(float))


def logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(p.astype(np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def quantile(x: np.ndarray, q: float) -> float:
    """The ``q`` quantile as a value of ``x`` (no interpolation, so an
    infinite value counts as one)."""
    return float(np.quantile(x, q, method="higher"))


def forward_readings(prog, ref) -> Dict[str, float]:
    """One image's program pre-NMS detections (boxes, scores, labels) numpy
    against the reference's every query (boxes (Q, 4), class scores
    (Q, C)).  Each program detection is matched to the reference query
    whose box overlaps it most, if that IoU is 0.5 or more, and compared
    with that query's box and its score for the detection's class, whether
    or not the reference ranks the pair in its own top 300: which near-tied
    random scores make the top 300 is chaotic, a matched query's score is
    not.

    - ``fwd.unmatched_share``: the share of the program's detections that
      match no reference query;
    - ``fwd.nlogit_gap_med``, ``fwd.nlogit_gap_p90``: the median and the
      90th percentile, over every program detection, of the |logit
      difference| (the scores' inverse sigmoid, where the forward's
      rounding errors land before the sigmoid squeezes them) over the
      spread (standard deviation) of the reference's logits of every query
      and class, which sets the scale of the errors and differs from seed
      to seed; an unmatched detection counts as an infinite gap;
    - ``fwd.box_gap_p90``: the 90th percentile over the matched detections
      of the largest coordinate difference, x over the reference box's
      width and y over its height (at least a pixel each); 1 with none
      matched."""
    pb, ps, pl = prog
    qb, qs = ref
    iou = iou_matrix(pb, qb)
    best = iou.argmax(1)
    hit = iou[np.arange(len(pb)), best] >= MATCH_IOU
    gap = np.abs(logit(ps) - logit(qs[best, pl])) / max(float(logit(qs).std()), 1e-6)
    gap = np.where(hit, gap, np.inf)
    out = {"fwd.unmatched_share": float(1.0 - hit.mean()),
           "fwd.nlogit_gap_med": quantile(gap, 0.5), "fwd.nlogit_gap_p90": quantile(gap, 0.9)}
    if not hit.any():
        return dict(out, **{"fwd.box_gap_p90": 1.0})
    mb = qb[best[hit]].astype(np.float64)
    size = np.maximum(np.stack([mb[:, 2] - mb[:, 0], mb[:, 3] - mb[:, 1]] * 2, 1), 1.0)  # w, h, w, h
    box = (np.abs(pb[hit].astype(np.float64) - mb) / size).max(1)
    return dict(out, **{"fwd.box_gap_p90": quantile(box, 0.9)})


def post_readings(served, want) -> Dict[str, float]:
    """One image's served (boxes, scores, labels, keep) against the
    reference's postprocess of the same pre-NMS detections.

    - ``post.score_gap``: largest |score difference| row by row, a row not
      kept scoring 0 and a kept row whose label differs counting its
      score in full;
    - ``post.box_gap``: largest coordinate difference (px of the original
      image) over rows kept on both sides."""
    sb, ss, sl, sk = served
    wb, ws, wl, wk = want
    s_val = np.where(sk, ss, 0.0)
    w_val = np.where(wk, ws, 0.0)
    gap = np.abs(s_val - w_val)
    wrong_label = sk & wk & (sl != wl)
    gap = np.where(wrong_label, np.maximum(s_val, w_val), gap)
    both = sk & wk
    box = float(np.abs(sb - wb).max(1)[both].max()) if both.any() else 0.0
    return {"post.score_gap": float(gap.max()) if gap.size else 0.0, "post.box_gap": box}


def numpy_of(*ts) -> Tuple[np.ndarray, ...]:
    return tuple(t.detach().float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy() for t in ts)


@torch.no_grad()
def reference_view(cfg: dict, model, canvas, image: np.ndarray):
    """The reference's preprocess and forward of ``image``: -> (its every
    query's (boxes, class scores) numpy, its scale factor)."""
    device = next(model.parameters()).device
    pre = cfg["preprocess"]
    x, mask, scale = pipeline.preprocess(image, canvas[0], canvas[1], pre["mean"], pre["std"], device)
    return numpy_of(*(t[0] for t in model.queries(x, mask))), scale


@torch.no_grad()
def image_readings(cfg: dict, ref, scale, prog_pre, served, device) -> Dict[str, float]:
    """All readings of one image: ``prog_pre`` (the program's boxes, scores,
    labels tensors of this image) against ``ref`` (``reference_view``), and
    ``served`` against the reference's postprocess of ``prog_pre``."""
    out = forward_readings(numpy_of(*prog_pre), ref)
    b, s, l = (t.to(device) for t in prog_pre)
    out.update(post_readings(served, numpy_of(*pipeline.postprocess(b, s, l, scale, cfg))))
    return out


def worst(per_image: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's largest value over the images checked."""
    return {k: max(r[k] for r in per_image) for k in per_image[0]}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """(every compared number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": readings[k], "limit": v} for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
