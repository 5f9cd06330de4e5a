"""Co-DINO training losses: Hungarian matching + QFL / L1 / GIoU.

A function-by-function port of the JAX package's ``parallel/losses.py``,
with its names and arithmetic (the same eps, the QFL positive-replacement
form).  The recipe is the reference training config's query-head losses
(configs/co_dino_5scale_r50_lsj_8xb2_1x_coco.py):

- assigner: HungarianAssigner with FocalLossCost(weight=2),
  BBoxL1Cost(weight=5, box_format='xywh'), IoUCost(giou, weight=2)  (:197-204)
- loss_cls: QualityFocalLoss(use_sigmoid=True, beta=2, weight=1)     (:107-111)
- loss_bbox: L1Loss(weight=5); loss_iou: GIoULoss(weight=2)          (:112-113)

Ground truth arrives padded to a fixed ``max_gt`` with a validity mask.
Every decoder layer and the encoder stage are supervised.  The matching
runs on the predictions' device with no host round trip
(``ops.hungarian.linear_assignment``: on the card the hand-written kernel,
one launch for every decoder stage and image, one for the encoder stage's
images); the per-image ``vmap`` of the JAX package is a batch dimension.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from codetr_torch.ops.hungarian import linear_assignment


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
    """(..., N, 4) x (..., M, 4) xyxy -> (..., N, M) GIoU."""
    return giou(boxes1[..., :, None, :], boxes2[..., None, :, :])


def _focal_cost(cls_prob: torch.Tensor, gt_labels: torch.Tensor,
                alpha: float = 0.25, gamma: float = 2.0) -> torch.Tensor:
    """mmdet FocalLossCost: (..., nq, ncls) probs, (..., max_gt) labels ->
    (..., max_gt, nq)."""
    eps = 1e-12
    neg = -torch.log(1 - cls_prob + eps) * (1 - alpha) * cls_prob**gamma
    pos = -torch.log(cls_prob + eps) * alpha * (1 - cls_prob) ** gamma
    idx = gt_labels[..., None, :].expand(*cls_prob.shape[:-1], gt_labels.shape[-1])
    return (pos.gather(-1, idx) - neg.gather(-1, idx)).transpose(-1, -2)


def matching_cost(
    cls_logits: torch.Tensor,  # (..., nq, ncls)
    pred_cxcywh: torch.Tensor,  # (..., nq, 4) normalised
    gt_cxcywh: torch.Tensor,  # (..., max_gt, 4) normalised, padded
    gt_labels: torch.Tensor,  # (..., max_gt) int64, padded
    *,
    cost_cls: float = 2.0,
    cost_bbox: float = 5.0,
    cost_iou: float = 2.0,
) -> torch.Tensor:
    """The assigner's cost (reference config :197-204), (..., max_gt, nq)
    float32: a row per gt, a column per query, as the JAX package hands
    ``cost.T`` to optax.  Padding rows are left as they come: the matching
    solves the valid rows only."""
    c_cls = _focal_cost(cls_logits.sigmoid(), gt_labels)
    c_l1 = (pred_cxcywh[..., None, :, :] - gt_cxcywh[..., :, None, :]).abs().sum(-1)
    c_giou = -giou_matrix(cxcywh_to_xyxy(gt_cxcywh), cxcywh_to_xyxy(pred_cxcywh))  # GIoU is symmetric
    return cost_cls * c_cls + cost_bbox * c_l1 + cost_iou * c_giou


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
    invalid gts get query 0 with match_valid False.  Non-finite costs give
    -1 in every row (see ``match_stages``); the caller checks before
    indexing with it.  One problem of ``linear_assignment``;
    ``dino_detection_loss`` solves a stage's images together."""
    cost = matching_cost(cls_logits, pred_cxcywh, gt_cxcywh, gt_labels.long(),
                         cost_cls=cost_cls, cost_bbox=cost_bbox, cost_iou=cost_iou)
    return linear_assignment(cost[None], gt_valid[None])[0], gt_valid


def quality_focal_loss(
    cls_logits: torch.Tensor,  # (..., nq, ncls)
    matched_idx: torch.Tensor,  # (..., max_gt)
    gt_labels: torch.Tensor,  # (..., max_gt)
    quality: torch.Tensor,  # (..., max_gt) IoU of matched pred vs gt, detached
    match_valid: torch.Tensor,  # (..., max_gt)
    beta: float = 2.0,
) -> torch.Tensor:
    """QualityFocalLoss(use_sigmoid=True, beta=2) (reference config :107-111):
    negatives weighted by sigmoid(p)^beta toward 0; each matched (query,
    label) entry supervised toward its IoU quality with |q - p|^beta scaling.
    Returns the summed loss of each image (the caller divides by
    avg_factor)."""
    p = cls_logits.sigmoid()
    bce_neg = cls_logits.clamp(min=0) + torch.log1p(torch.exp(-cls_logits.abs()))
    loss = p**beta * bce_neg  # (..., nq, ncls)

    # positive replacement at (matched_idx, gt_label)
    q = torch.where(match_valid, quality, torch.zeros_like(quality))
    at = matched_idx * cls_logits.shape[-1] + gt_labels  # flat (query, label) index
    logit_pos = cls_logits.flatten(-2).gather(-1, at)  # (..., max_gt)
    p_pos = logit_pos.sigmoid()
    bce_q = logit_pos.clamp(min=0) - logit_pos * q + torch.log1p(torch.exp(-logit_pos.abs()))
    pos_loss = (q - p_pos).abs() ** beta * bce_q
    neg_at_pos = loss.flatten(-2).gather(-1, at)
    delta = torch.where(match_valid, pos_loss - neg_at_pos, torch.zeros_like(pos_loss))
    return loss.sum((-2, -1)) + delta.sum(-1)


def _stage_loss(cls_logits, pred_coords, gt_boxes, gt_labels, gt_valid, matched):
    """Losses of one supervised stage, per image: (bs, nq, ncls) logits,
    (bs, nq, 4) boxes, the gts and each gt's matched query (bs, max_gt)."""
    pred_at = pred_coords.gather(1, matched[..., None].expand(*matched.shape, 4))  # (bs, max_gt, 4)
    pred_xyxy = cxcywh_to_xyxy(pred_at)
    gt_xyxy = cxcywh_to_xyxy(gt_boxes)
    g = giou(pred_xyxy, gt_xyxy)
    iou_q = iou_aligned(pred_xyxy, gt_xyxy).detach()
    loss_cls = quality_focal_loss(cls_logits, matched, gt_labels, iou_q, gt_valid)
    vf = gt_valid.float()
    loss_l1 = ((pred_at - gt_boxes).abs().sum(-1) * vf).sum(-1)
    loss_giou = ((1.0 - g) * vf).sum(-1)
    return loss_cls, loss_l1, loss_giou, vf.sum(-1)


@torch.no_grad()
def matching_problems(
    outputs: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor,
    gt_valid: torch.Tensor,
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The step's two batches of assignment problems, each (cost, row_valid)
    for ``linear_assignment``: every decoder layer and image (nl x bs
    problems over nq queries), then the encoder stage's images (bs over K)."""
    nl = outputs["all_cls_logits"].shape[0]
    gt_labels = gt_labels.long()
    # the gts broadcast over the decoder layers
    dec = matching_cost(outputs["all_cls_logits"], outputs["all_coords"], gt_boxes, gt_labels)
    enc = matching_cost(outputs["enc_cls_logits"], outputs["enc_coords"], gt_boxes, gt_labels)
    return (dec.flatten(0, 1), gt_valid.repeat(nl, 1)), (enc, gt_valid)


def match_stages(outputs, gt_boxes, gt_labels, gt_valid) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each supervised stage's matched query per gt: (nl, bs, max_gt) for
    the decoder layers and (bs, max_gt) for the encoder stage, in two
    ``linear_assignment`` calls.

    ``linear_assignment`` gives -1 to every row of a problem whose
    non-finite costs (from a NaN or infinite logit or box) leave a search
    no free column at a finite distance; the losses' gathers cannot take
    such an index.  So each result is asserted non-negative on
    the device, without a host read: on the CPU the assert raises at once
    with the message below; on the card it fails the next synchronising
    call with a device-side assert of ``_assert_async``, which, as every
    device-side assert, leaves the CUDA context unusable."""
    nl, bs = outputs["all_cls_logits"].shape[:2]
    dec, enc = (linear_assignment(*problems)
                for problems in matching_problems(outputs, gt_boxes, gt_labels, gt_valid))
    for matched in (dec, enc):
        torch._assert_async((matched >= 0).all(), "the matching costs are not finite (NaN or inf outputs)")
    return dec.view(nl, bs, -1), enc


def dino_detection_loss(
    outputs: Dict[str, torch.Tensor],
    gt_boxes: torch.Tensor,  # (bs, max_gt, 4) normalised cxcywh
    gt_labels: torch.Tensor,  # (bs, max_gt) int
    gt_valid: torch.Tensor,  # (bs, max_gt) bool
    *,
    w_cls: float = 1.0,
    w_bbox: float = 5.0,
    w_iou: float = 2.0,
    num_gts: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Total loss over all decoder layers + the encoder stage (the aux
    supervision pattern of mmdet DINO loss_by_feat), and each stage's
    class, box and GIoU losses by name.  Nothing here waits for the device:
    on the card it runs with no host synchronisation.

    Every stage's summed losses are divided by ``num_gts`` (at least 1):
    the batch's valid gts by default.  A data-parallel step passes the
    count of the whole batch, so that its ranks' losses sum to the
    whole batch's loss (``parallel/train.py:jit_train_step``)."""
    all_cls = outputs["all_cls_logits"]  # (nl, bs, nq, ncls)
    all_coords = outputs["all_coords"]  # (nl, bs, nq, 4)
    nl = all_cls.shape[0]
    gt_labels = gt_labels.long()
    dec_matched, enc_matched = match_stages(outputs, gt_boxes, gt_labels, gt_valid)
    stages = [(all_cls[i], all_coords[i], dec_matched[i]) for i in range(nl)]
    stages.append((outputs["enc_cls_logits"], outputs["enc_coords"], enc_matched))

    total = torch.zeros((), dtype=torch.float32, device=all_cls.device)
    logs = {}
    for si, (cl, co, matched) in enumerate(stages):
        lc, l1, lg, npos = _stage_loss(cl, co, gt_boxes, gt_labels, gt_valid, matched)
        denom = (npos.sum() if num_gts is None else num_gts).clamp(min=1.0)
        lc, l1, lg = lc.sum() / denom, l1.sum() / denom, lg.sum() / denom
        total = total + (w_cls * lc + w_bbox * l1 + w_iou * lg)
        name = f"d{si}" if si < nl else "enc"
        logs[f"loss_cls_{name}"] = lc
        logs[f"loss_bbox_{name}"] = l1
        logs[f"loss_iou_{name}"] = lg
    return total, logs
