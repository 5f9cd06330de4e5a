"""End-to-end inference: preprocess -> model -> (soft-)NMS postprocess.

Per batch of images: keep-ratio resize, pad, normalise and mask on the
model's device; one forward; per-class (soft-)NMS with static shapes on the
device; boxes rescaled to original-image pixels.  Results come back as
fixed-size numpy arrays plus a keep mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np
import torch

from codetr_torch.models.codetr import CoDETR, check_device
from codetr_torch.ops.nms import postprocess_detections
from codetr_torch.utils.preprocess import preprocess


@dataclass
class Detections:
    """Fixed-size detection set; ``keep`` masks the valid rows."""

    boxes: np.ndarray  # (N, 4) xyxy in original-image pixels
    scores: np.ndarray  # (N,)
    labels: np.ndarray  # (N,)
    keep: np.ndarray  # (N,) bool

    def compact(self) -> "Detections":
        k = self.keep
        return Detections(self.boxes[k], self.scores[k], self.labels[k], np.ones(k.sum(), bool))


class Inferencer:
    """Serves images at a fixed (height, width) and batch size.

    Images are collated into batches of ``batch_size``; a short last batch
    is padded by repeating its last image and the padding's results are
    dropped.  Thresholds default to the config's test_cfg (score 0, soft-NMS
    at iou 0.8).  ``device`` must be the model's; CUDA by default, and
    without a card it raises.
    """

    def __init__(
        self,
        model: CoDETR,
        *,
        height: int,
        width: int,
        batch_size: int = 1,
        score_threshold: float | None = None,
        iou_threshold: float | None = None,
        nms_type: str | None = None,
        device="cuda",
    ):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        model_device = next(model.parameters()).device
        if model_device.type != check_device(device).type:
            raise ValueError(f"the model is on {model_device}, not {device}")
        self.device = model_device
        self.model = model
        self.cfg = model.cfg
        head = self.cfg.head
        self.height, self.width, self.batch_size = height, width, batch_size
        self.score_threshold = head.score_threshold if score_threshold is None else score_threshold
        self.iou_threshold = head.nms_iou_threshold if iou_threshold is None else iou_threshold
        self.nms_type = head.nms_type if nms_type is None else nms_type

    @torch.inference_mode()
    def __call__(self, images: Sequence[np.ndarray]) -> List[Detections]:
        """images: (H, W, 3) RGB uint8 arrays, any count."""
        bs = self.batch_size
        head = self.cfg.head
        outs: List[Detections] = []
        for i in range(0, len(images), bs):
            chunk = list(images[i:i + bs])
            n = len(chunk)
            chunk += [chunk[-1]] * (bs - n)  # pad by repeating the last image
            pre = [
                preprocess(im, self.height, self.width, self.cfg.preprocess, device=self.device)
                for im in chunk
            ]
            inputs = torch.stack([p[0] for p in pre])
            masks = torch.stack([p[1] for p in pre])
            boxes, scores, labels = self.model(inputs, masks)
            sf = torch.tensor(
                [[p[2][0], p[2][1], p[2][0], p[2][1]] for p in pre],
                dtype=torch.float32, device=self.device,
            )[:, None, :]
            b, s, l, keep = postprocess_detections(
                boxes, scores, labels,
                score_threshold=self.score_threshold,
                iou_threshold=self.iou_threshold,
                scale_factor=sf,
                nms_type=self.nms_type,
                nms_sigma=head.nms_sigma,
                nms_min_score=head.nms_min_score,
            )
            b, s, l, keep = (t.cpu().numpy() for t in (b, s, l, keep))
            outs.extend(Detections(b[j], s[j], l[j], keep[j]) for j in range(n))
        return outs
