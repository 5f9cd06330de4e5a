"""Fixed-shape NMS and soft-NMS in plain torch (no torchvision).

Every function keeps its input's shape: ``keep`` is a boolean mask and
suppressed or discarded entries get score -inf, so the results stay
shape-static on any device.

- ``nms``: greedy NMS in score-descending order (torchvision.ops.nms);
- ``batched_nms``: per-class NMS by the coordinate-offset trick;
- ``soft_nms``: linear or gaussian rescoring (mmcv.ops.soft_nms);
- ``soft_batched_nms``: per-class soft-NMS by the same trick;
- ``postprocess_detections``: score gate + (soft-)NMS + rescale, batched.
"""

from __future__ import annotations

from typing import Optional

import torch


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (N, 4) xyxy boxes -> (N, N); 0 where the union is 0."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    w = (torch.minimum(x2[:, None], x2[None, :]) - torch.maximum(x1[:, None], x1[None, :])).clamp(min=0)
    h = (torch.minimum(y2[:, None], y2[None, :]) - torch.maximum(y1[:, None], y1[None, :])).clamp(min=0)
    inter = w * h
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep mask in input order; -inf scores never survive."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    overlap = _iou_matrix(boxes[order]) > iou_threshold
    valid = torch.isfinite(scores[order])
    keep = torch.zeros(n, dtype=torch.bool, device=boxes.device)
    for i in range(n):  # keep[j] is still False for every j >= i
        keep[i] = valid[i] & ~(keep & overlap[i]).any()
    out = torch.zeros_like(keep)
    out[order] = keep
    return out


def _class_offset(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    finite = torch.isfinite(scores)[:, None]
    max_coord = torch.where(finite, boxes, torch.zeros_like(boxes)).max()
    return boxes + (labels.to(boxes.dtype) * (max_coord + 1.0))[:, None]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Class-agnostic NMS keep mask."""
    return _nms_mask(boxes, scores, iou_threshold)


def batched_nms(boxes, scores, labels, iou_threshold: float) -> torch.Tensor:
    """Per-class NMS keep mask; boxes (N, 4), scores (N,), labels (N,)."""
    return _nms_mask(_class_offset(boxes, scores, labels), scores, iou_threshold)


def _soft_nms_scores(boxes, scores, iou_threshold, sigma, min_score, method):
    """Greedy rescoring: take the best unprocessed box, freeze its score,
    decay the rest by their overlap with it (linear: 1 - iou above the
    threshold; gaussian: exp(-iou^2 / sigma)).  Boxes that fall below
    ``min_score`` are discarded (-inf).  Runs n steps with no host sync."""
    if method not in ("linear", "gaussian"):
        raise ValueError(f"unknown soft-NMS method {method!r}")
    n = boxes.shape[0]
    iou = _iou_matrix(boxes)
    idx = torch.arange(n, device=scores.device)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    one = torch.ones((), dtype=scores.dtype, device=scores.device)
    cur = scores
    final = torch.full_like(scores, float("-inf"))
    done = torch.zeros(n, dtype=torch.bool, device=scores.device)
    # the selected index stays a device tensor: indexing with it would copy
    # it to the host and wait for the device at every step
    for _ in range(n):
        best, i = torch.where(done, neg_inf, cur).max(0)  # first maximum
        ok = best >= min_score  # a no-op once nothing survives
        sel = (idx == i) & ok
        final = torch.where(sel, best, final)
        done = done | sel
        iou_i = iou.index_select(0, i.view(1))[0]
        if method == "linear":
            decay = torch.where(iou_i > iou_threshold, 1.0 - iou_i, one)
        else:
            decay = torch.exp(-(iou_i * iou_i) / sigma)
        cur = torch.where(ok & ~done, cur * decay, cur)
    return final


def soft_nms(boxes, scores, iou_threshold: float = 0.3, sigma: float = 0.5,
             min_score: float = 1e-3, method: str = "linear") -> torch.Tensor:
    """Class-agnostic soft-NMS; returns the final per-box scores."""
    return _soft_nms_scores(boxes, scores, iou_threshold, sigma, min_score, method)


def soft_batched_nms(boxes, scores, labels, iou_threshold: float, sigma: float,
                     min_score: float, method: str = "linear") -> torch.Tensor:
    """Per-class soft-NMS by the coordinate-offset trick."""
    shifted = _class_offset(boxes, scores, labels)
    return _soft_nms_scores(shifted, scores, iou_threshold, sigma, min_score, method)


def postprocess_detections(
    boxes: torch.Tensor,  # (bs, N, 4)
    scores: torch.Tensor,  # (bs, N)
    labels: torch.Tensor,  # (bs, N)
    *,
    score_threshold: float,
    iou_threshold: float,
    scale_factor: Optional[torch.Tensor] = None,  # broadcastable to boxes
    nms_type: str = "nms",
    nms_sigma: float = 0.5,
    nms_min_score: float = 1e-3,
):
    """Score gate + per-class (soft-)NMS + rescale.  Returns (boxes, scores,
    labels, keep) with the input shapes; soft-NMS returns the decayed scores,
    dropped entries score -inf."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=scores.device)
    gated = torch.where(scores >= score_threshold, scores, neg_inf)
    if nms_type == "nms":
        keep = torch.stack([
            batched_nms(b, s, l, iou_threshold) for b, s, l in zip(boxes, gated, labels)
        ])
        keep = keep & (gated > neg_inf)
        out_scores = torch.where(keep, scores, neg_inf)
    elif nms_type in ("soft_nms", "soft_nms_gaussian"):
        method = "gaussian" if nms_type.endswith("gaussian") else "linear"
        out_scores = torch.stack([
            soft_batched_nms(b, s, l, iou_threshold, nms_sigma, nms_min_score, method)
            for b, s, l in zip(boxes, gated, labels)
        ])
        keep = torch.isfinite(out_scores)
    else:
        raise ValueError(f"unknown nms_type {nms_type!r}")
    if scale_factor is not None:
        boxes = boxes / scale_factor
    return boxes, out_scores, labels, keep
