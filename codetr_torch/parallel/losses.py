"""Co-DINO training losses: Hungarian matching + QFL / L1 / GIoU.

A function-by-function port of the JAX package's ``parallel/losses.py``,
with its names and arithmetic (the same eps, ``INVALID_COST``, the QFL
positive-replacement form).  The recipe is the reference training config's
query-head losses (configs/co_dino_5scale_r50_lsj_8xb2_1x_coco.py):

- assigner: HungarianAssigner with FocalLossCost(weight=2),
  BBoxL1Cost(weight=5, box_format='xywh'), IoUCost(giou, weight=2)  (:197-204)
- loss_cls: QualityFocalLoss(use_sigmoid=True, beta=2, weight=1)     (:107-111)
- loss_bbox: L1Loss(weight=5); loss_iou: GIoULoss(weight=2)          (:112-113)

Ground truth arrives padded to a fixed ``max_gt`` with a validity mask.
Every decoder layer and the encoder stage are supervised.  The per-image
``vmap`` of the JAX package is a loop over the batch here.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from scipy.optimize import linear_sum_assignment

INVALID_COST = 1e6


def cxcywh_to_xyxy(b: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


def _area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)


def iou_aligned(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned (..., 4) xyxy boxes."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (_area(boxes1) + _area(boxes2) - inter).clamp(min=1e-9)


def giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of aligned (..., 4) xyxy boxes."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(boxes1) + _area(boxes2) - inter
    iou = inter / union.clamp(min=1e-9)
    elt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    erb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    ewh = (erb - elt).clamp(min=0.0)
    enclose = (ewh[..., 0] * ewh[..., 1]).clamp(min=1e-9)
    return iou - (enclose - union) / enclose


def giou_matrix(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """(N, 4) x (M, 4) xyxy -> (N, M) GIoU."""
    return giou(boxes1[:, None, :], boxes2[None, :, :])


def _focal_cost(cls_prob: torch.Tensor, gt_labels: torch.Tensor,
                alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """mmdet FocalLossCost: (nq, ncls) probs, (max_gt,) labels -> (nq, max_gt)."""
    eps = 1e-12
    neg = -torch.log(1 - cls_prob + eps) * (1 - alpha) * cls_prob**gamma
    pos = -torch.log(cls_prob + eps) * alpha * (1 - cls_prob) ** gamma
    return pos[:, gt_labels] - neg[:, gt_labels]


@torch.no_grad()
def hungarian_match(
    cls_logits: torch.Tensor,  # (nq, ncls)
    pred_cxcywh: torch.Tensor,  # (nq, 4) normalised
    gt_cxcywh: torch.Tensor,  # (max_gt, 4) normalised, padded
    gt_labels: torch.Tensor,  # (max_gt,) int, padded
    gt_valid: torch.Tensor,  # (max_gt,) bool
    *,
    cost_cls: float = 2.0,
    cost_bbox: float = 5.0,
    cost_iou: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image Hungarian assignment (reference config :197-204).

    Returns (matched_pred_idx (max_gt,), match_valid (max_gt,)) on the
    logits' device: for each (padded) gt, the index of its assigned query;
    invalid gts get an arbitrary assignment with match_valid False.  The
    cost matrix is built on the device; invalid gts carry a flat cost, so
    they cannot change the valid gts' optimum.  It is solved on the host by
    ``scipy.optimize.linear_sum_assignment``: one device-to-host round trip
    per call, i.e. per supervised stage and image.
    """
    prob = cls_logits.sigmoid()
    c_cls = _focal_cost(prob, gt_labels)  # (nq, max_gt)
    c_l1 = (pred_cxcywh[:, None, :] - gt_cxcywh[None, :, :]).abs().sum(-1)
    c_giou = -giou_matrix(cxcywh_to_xyxy(pred_cxcywh), cxcywh_to_xyxy(gt_cxcywh))
    cost = cost_cls * c_cls + cost_bbox * c_l1 + cost_iou * c_giou  # (nq, max_gt)
    cost = torch.where(gt_valid[None, :], cost, torch.full_like(cost, INVALID_COST))
    # rows = gts (max_gt <= nq): one query per gt, rows come back in order
    _, pred_idx = linear_sum_assignment(cost.T.cpu().numpy())
    return torch.from_numpy(pred_idx).to(cls_logits.device), gt_valid


def quality_focal_loss(
    cls_logits: torch.Tensor,  # (nq, ncls)
    matched_idx: torch.Tensor,  # (max_gt,)
    gt_labels: torch.Tensor,  # (max_gt,)
    quality: torch.Tensor,  # (max_gt,) IoU of matched pred vs gt, detached
    match_valid: torch.Tensor,  # (max_gt,)
    beta: float = 2.0,
) -> torch.Tensor:
    """QualityFocalLoss(use_sigmoid=True, beta=2) (reference config :107-111):
    negatives weighted by sigmoid(p)^beta toward 0; each matched (query,
    label) entry supervised toward its IoU quality with |q - p|^beta scaling.
    Returns the summed loss (the caller divides by avg_factor)."""
    p = cls_logits.sigmoid()
    bce_neg = cls_logits.clamp(min=0) + torch.log1p(torch.exp(-cls_logits.abs()))
    loss = p**beta * bce_neg  # (nq, ncls)

    # positive replacement at (matched_idx, gt_label)
    q = torch.where(match_valid, quality, torch.zeros_like(quality))
    logit_pos = cls_logits[matched_idx, gt_labels]  # (max_gt,)
    p_pos = logit_pos.sigmoid()
    bce_q = logit_pos.clamp(min=0) - logit_pos * q + torch.log1p(torch.exp(-logit_pos.abs()))
    pos_loss = (q - p_pos).abs() ** beta * bce_q
    neg_at_pos = loss[matched_idx, gt_labels]
    delta = torch.where(match_valid, pos_loss - neg_at_pos, torch.zeros_like(pos_loss))
    return loss.sum() + delta.sum()


def _stage_loss(cls_logits, pred_coords, gt_boxes, gt_labels, gt_valid):
    """Losses of one supervised stage for one image."""
    matched, valid = hungarian_match(cls_logits, pred_coords, gt_boxes, gt_labels, gt_valid)
    pred_at = pred_coords[matched]  # (max_gt, 4)
    pred_xyxy = cxcywh_to_xyxy(pred_at)
    gt_xyxy = cxcywh_to_xyxy(gt_boxes)
    g = giou(pred_xyxy, gt_xyxy)
    iou_q = iou_aligned(pred_xyxy, gt_xyxy).detach()
    loss_cls = quality_focal_loss(cls_logits, matched, gt_labels, iou_q, valid)
    vf = valid.float()
    loss_l1 = ((pred_at - gt_boxes).abs().sum(-1) * vf).sum()
    loss_giou = ((1.0 - g) * vf).sum()
    return loss_cls, loss_l1, loss_giou, vf.sum()


def dino_detection_loss(
    outputs: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,  # (bs, max_gt, 4) normalised cxcywh
    gt_labels: torch.Tensor,  # (bs, max_gt) int
    gt_valid: torch.Tensor,  # (bs, max_gt) bool
    *,
    w_cls: float = 1.0,
    w_bbox: float = 5.0,
    w_iou: float = 2.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over all decoder layers + the encoder stage (the aux
    supervision pattern of mmdet DINO loss_by_feat), and each stage's
    class, box and GIoU losses by name."""
    all_cls = outputs["all_cls_logits"]  # (nl, bs, nq, ncls)
    all_coords = outputs["all_coords"]  # (nl, bs, nq, 4)
    nl = all_cls.shape[0]
    stages = [(all_cls[i], all_coords[i]) for i in range(nl)]
    stages.append((outputs["enc_cls_logits"], outputs["enc_coords"]))

    total = torch.zeros((), dtype=torch.float32, device=all_cls.device)
    logs = {}
    for si, (cl, co) in enumerate(stages):
        per_image = [
            _stage_loss(cl[b], co[b], gt_boxes[b], gt_labels[b], gt_valid[b])
            for b in range(cl.shape[0])
        ]
        lc, l1, lg, npos = (torch.stack(t) for t in zip(*per_image))
        denom = npos.sum().clamp(min=1.0)
        lc, l1, lg = lc.sum() / denom, l1.sum() / denom, lg.sum() / denom
        total = total + (w_cls * lc + w_bbox * l1 + w_iou * lg)
        name = f"d{si}" if si < nl else "enc"
        logs[f"loss_cls_{name}"] = lc
        logs[f"loss_bbox_{name}"] = l1
        logs[f"loss_iou_{name}"] = lg
    return total, logs
