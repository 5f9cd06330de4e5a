"""Fixed-shape NMS and soft-NMS in plain torch (no torchvision), batched
over images.

Every function keeps its input's shape: ``keep`` is a boolean mask and
suppressed or discarded entries get score -inf, so the results stay
shape-static on any device.  The core works on (bs, N) tensors, one
N-step loop for every image of a batch (the JAX package's ``vmap``), and
dispatches no host read and no host-to-device copy, so one call can be
captured in a CUDA graph (``inferencer.Inferencer`` does).

- ``nms``: greedy NMS in score-descending order (torchvision.ops.nms);
- ``batched_nms``: per-class NMS by the coordinate-offset trick;
- ``soft_nms``: linear or gaussian rescoring (mmcv.ops.soft_nms);
- ``soft_batched_nms``: per-class soft-NMS by the same trick;
- ``postprocess_detections``: score gate + (soft-)NMS + rescale, batched.

The four single-image functions take (N, 4) boxes and (N,) scores and run
the core with bs = 1.
"""

from __future__ import annotations

from typing import Optional

import torch


def _iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of (..., N, 4) xyxy boxes -> (..., N, N); 0 where the
    union is 0."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)

    def pair(a):  # (..., N) -> (..., N, 1), (..., 1, N)
        return a[..., :, None], a[..., None, :]

    w = (torch.minimum(*pair(x2)) - torch.maximum(*pair(x1))).clamp(min=0)
    h = (torch.minimum(*pair(y2)) - torch.maximum(*pair(y1))).clamp(min=0)
    inter = w * h
    a_i, a_j = pair(area)
    union = a_i + a_j - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def _nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Greedy NMS keep masks in input order, (bs, N, 4) and (bs, N) ->
    (bs, N); -inf scores never survive.  The stable argsort keeps the JAX
    argsort's order among equal scores."""
    n = scores.shape[-1]
    order = torch.argsort(-scores, dim=-1, stable=True)
    boxes_s = boxes.gather(1, order[..., None].expand(-1, -1, 4))
    overlap = _iou_matrix(boxes_s) > iou_threshold
    valid = torch.isfinite(scores.gather(1, order))
    keep = torch.zeros_like(valid)
    for i in range(n):  # keep[:, j] is still False for every j >= i
        keep[:, i] = valid[:, i] & ~(keep & overlap[:, i]).any(-1)
    return torch.zeros_like(keep).scatter_(1, order, keep)


def _class_offset(boxes: torch.Tensor, scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Boxes shifted apart by class, (bs, N, 4).  The shift is each image's
    own largest finite-score coordinate + 1 (the JAX ``vmap`` of
    ``batched_nms``): a batch-wide one would change the IoUs' rounding."""
    finite = torch.isfinite(scores)[..., None]
    max_coord = torch.where(finite, boxes, torch.zeros_like(boxes)).amax(dim=(-2, -1))
    return boxes + (labels.to(boxes.dtype) * (max_coord[:, None] + 1.0))[..., None]


def _soft_nms_scores(boxes, scores, iou_threshold, sigma, min_score, method):
    """Greedy rescoring, (bs, N, 4) and (bs, N) -> (bs, N): take each image's
    best unprocessed box (the first maximum, as JAX's argmax), freeze its
    score, decay the rest by their overlap with it (linear: 1 - iou above
    the threshold; gaussian: exp(-iou^2 / sigma)).  Boxes that fall below
    ``min_score`` are discarded (-inf).  N steps; the selected index stays
    a device tensor (indexing with it would copy it to the host and wait
    for the device at every step)."""
    if method not in ("linear", "gaussian"):
        raise ValueError(f"unknown soft-NMS method {method!r}")
    n = scores.shape[-1]
    iou = _iou_matrix(boxes)
    one = torch.ones((), dtype=scores.dtype, device=scores.device)
    # every row's decay at once: the same element-wise arithmetic as on
    # the selected row alone
    if method == "linear":
        decay = torch.where(iou > iou_threshold, 1.0 - iou, one)
    else:
        decay = torch.exp(-(iou * iou) / sigma)
    idx = torch.arange(n, device=scores.device)
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    cur = scores
    final = torch.full_like(scores, float("-inf"))
    done = torch.zeros_like(scores, dtype=torch.bool)
    for _ in range(n):
        best, i = torch.where(done, neg_inf, cur).max(-1)
        ok = (best >= min_score)[:, None]  # a no-op once nothing survives
        sel = (idx == i[:, None]) & ok
        final = torch.where(sel, best[:, None], final)
        done = done | sel
        # each image's decay row i, by a gather: the index stays on the device
        decay_i = decay.gather(1, i[:, None, None].expand(-1, 1, n))[:, 0]
        cur = torch.where(ok & ~done, cur * decay_i, cur)
    return final


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Class-agnostic NMS keep mask; boxes (N, 4), scores (N,)."""
    return _nms_mask(boxes[None], scores[None], iou_threshold)[0]


def batched_nms(boxes, scores, labels, iou_threshold: float) -> torch.Tensor:
    """Per-class NMS keep mask; boxes (N, 4), scores (N,), labels (N,)."""
    b, s = boxes[None], scores[None]
    return _nms_mask(_class_offset(b, s, labels[None]), s, iou_threshold)[0]


def soft_nms(boxes, scores, iou_threshold: float = 0.3, sigma: float = 0.5,
             min_score: float = 1e-3, method: str = "linear") -> torch.Tensor:
    """Class-agnostic soft-NMS; returns the final per-box scores."""
    return _soft_nms_scores(boxes[None], scores[None], iou_threshold, sigma, min_score, method)[0]


def soft_batched_nms(boxes, scores, labels, iou_threshold: float, sigma: float,
                     min_score: float, method: str = "linear") -> torch.Tensor:
    """Per-class soft-NMS by the coordinate-offset trick."""
    b, s = boxes[None], scores[None]
    shifted = _class_offset(b, s, labels[None])
    return _soft_nms_scores(shifted, s, iou_threshold, sigma, min_score, method)[0]


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
    """Score gate + per-class (soft-)NMS + rescale, one loop for the whole
    batch.  Returns (boxes, scores, labels, keep) with the input shapes;
    soft-NMS returns the decayed scores, dropped entries score -inf."""
    if nms_type not in ("nms", "soft_nms", "soft_nms_gaussian"):
        raise ValueError(f"unknown nms_type {nms_type!r}")
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    gated = torch.where(scores >= score_threshold, scores, neg_inf)
    shifted = _class_offset(boxes, gated, labels)
    if nms_type == "nms":
        keep = _nms_mask(shifted, gated, iou_threshold) & (gated > neg_inf)
        out_scores = torch.where(keep, scores, neg_inf)
    else:
        method = "gaussian" if nms_type.endswith("gaussian") else "linear"
        out_scores = _soft_nms_scores(shifted, gated, iou_threshold, nms_sigma, nms_min_score, method)
        keep = torch.isfinite(out_scores)
    if scale_factor is not None:
        boxes = boxes / scale_factor
    return boxes, out_scores, labels, keep
