"""The reference's serving steps around the model, in plain PyTorch:
keep-ratio resize (cv2 ``INTER_LINEAR``'s fixed-point arithmetic), pad,
normalise and mask before it; per-class soft-NMS (mmcv's linear rescoring)
and the rescale to original-image pixels after it.

``postprocess(..., dtype=torch.bfloat16)`` runs the soft-NMS arithmetic in
bfloat16: the lower-precision control of this float32 step.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS: 2048 = 1.0


def rescale_size(old_w: int, old_h: int, new_w: int, new_h: int) -> Tuple[int, int]:
    """mmcv's keep-ratio target (w, h): scale by min(new/old), round."""
    scale = min(new_w / old_w, new_h / old_h)
    return int(old_w * scale + 0.5), int(old_h * scale + 0.5)


def _taps(src: int, dst: int, clamp: bool):
    """cv2 ``INTER_LINEAR``'s two source indices and 11-bit weights per
    output index on one axis (the horizontal axis clamps out-of-range
    positions to the border with weight 0, the vertical one only clamps the
    rows)."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp:
        f = np.where((s < 0) | (s >= src - 1), np.float32(0), f)
        s = np.clip(s, 0, src - 1)
    one = np.float32(1 << _COEF_BITS)
    a1 = np.rint(f * one).astype(np.int64)
    a0 = np.rint((np.float32(1) - f) * one).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


def resize(img: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W, 3) uint8 -> (th, tw, 3) uint8, as ``cv2.resize(...,
    INTER_LINEAR)`` computes it."""
    H, W = img.shape[:2]
    dev = img.device
    x0, x1, ax0, ax1 = (torch.from_numpy(a).to(dev) for a in _taps(W, tw, True))
    y0, y1, ay0, ay1 = (torch.from_numpy(a).to(dev) for a in _taps(H, th, False))
    x = img.to(torch.int32)
    rows = x[:, x0] * ax0.view(1, -1, 1).int() + x[:, x1] * ax1.view(1, -1, 1).int()
    v = ((ay0.view(-1, 1, 1).int() * (rows[y0] >> 4)) >> 16) + ((ay1.view(-1, 1, 1).int() * (rows[y1] >> 4)) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


def preprocess(image: np.ndarray, height: int, width: int, mean, std, device):
    """RGB uint8 (H, W, 3) -> (image (1, height, width, 3) normalised
    float32, mask (1, height, width) 1 = pad, scale (w_scale, h_scale))."""
    img = torch.from_numpy(np.ascontiguousarray(image)).to(device)
    oh, ow = img.shape[:2]
    tw, th = rescale_size(ow, oh, width, height)
    pix = resize(img, th, tw).float()
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device)
    std_t = torch.tensor(std, dtype=torch.float32, device=device)
    out = torch.zeros(height, width, 3, dtype=torch.float32, device=device)
    out[:th, :tw] = (pix - mean_t) / std_t
    mask = torch.ones(height, width, dtype=torch.float32, device=device)
    mask[:th, :tw] = 0.0
    return out[None], mask[None], (tw / ow, th / oh)


def _iou(boxes: torch.Tensor) -> torch.Tensor:
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    w = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(x1[:, None], x1[None])).clamp(min=0)
    h = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(y1[:, None], y1[None])).clamp(min=0)
    inter = w * h
    union = area[:, None] + area[None] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def soft_nms(boxes, scores, iou_threshold: float, min_score: float) -> torch.Tensor:
    """Linear soft-NMS of one image (N, 4), (N,) -> final scores, -inf for
    the discarded: repeatedly take the best unprocessed box (first maximum),
    fix its score and multiply the others' by (1 - iou) where iou exceeds
    the threshold; stop taking boxes below ``min_score``."""
    n = scores.shape[0]
    iou = _iou(boxes)
    decay = torch.where(iou > iou_threshold, 1.0 - iou, torch.ones_like(iou))
    cur = scores.clone()
    final = torch.full_like(scores, float("-inf"))
    done = torch.zeros(n, dtype=torch.bool, device=scores.device)
    for _ in range(n):
        masked = torch.where(done, torch.full_like(cur, float("-inf")), cur)
        i = int(torch.argmax(masked))
        best = masked[i]
        if not bool(best >= min_score):
            break
        final[i] = best
        done[i] = True
        cur = torch.where(done, cur, cur * decay[i])
    return final


def postprocess(boxes, scores, labels, scale, cfg: dict, dtype=torch.float32):
    """One image's pre-NMS (boxes (N, 4) canvas px, scores (N,), labels
    (N,)) -> (boxes in image px, final scores, labels, keep): score gate,
    per-class soft-NMS by the coordinate-offset trick (the offset is the
    largest kept coordinate + 1), boxes divided by (w, h, w, h) scale."""
    head = cfg["head"]
    if head["nms_type"] != "soft_nms":
        raise ValueError(f"the reference implements linear soft-NMS, not {head['nms_type']!r}")
    b, s = boxes.to(dtype), scores.to(dtype)
    gated = torch.where(s >= head["score_threshold"], s, torch.full_like(s, float("-inf")))
    finite = torch.isfinite(gated)[:, None]
    max_coord = torch.where(finite, b, torch.zeros_like(b)).max()
    shifted = b + (labels.to(dtype) * (max_coord + 1))[:, None]
    final = soft_nms(shifted, gated, head["nms_iou_threshold"], head["nms_min_score"])
    sf = torch.tensor([scale[0], scale[1], scale[0], scale[1]], dtype=torch.float32,
                      device=boxes.device).to(dtype)
    return (b / sf).float(), final.float(), labels, torch.isfinite(final)
