"""End-to-end inference: preprocess -> model -> (soft-)NMS postprocess.

Per batch of images: keep-ratio resize, pad, normalise and mask on the
model's device; one forward; per-class (soft-)NMS with static shapes on the
device; boxes rescaled to original-image pixels.  Results come back as
fixed-size numpy arrays plus a keep mask.  With ``device_preprocess=True``
(the fused-serving form) only the resize runs before the forward, onto a
fixed uint8 canvas; normalise, pad and mask run inside it
(``utils.preprocess.preprocess_in_graph``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from codetr_torch.models.codetr import CoDETR, check_device
from codetr_torch.ops.nms import postprocess_detections
from codetr_torch.utils.coco import COCO_CLASSES
from codetr_torch.utils.preprocess import preprocess, preprocess_in_graph, resize_to_canvas
from codetr_torch.utils.profiling import annotate


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

    def to_dict(self) -> dict:
        """The kept rows as JSON-able lists: ``labels``, ``scores``, ``bboxes``."""
        k = self.keep
        return {
            "labels": self.labels[k].tolist(),
            "scores": [float(s) for s in self.scores[k]],
            "bboxes": [[float(v) for v in b] for b in self.boxes[k]],
        }


class Inferencer:
    """Serves images at a fixed (height, width) and batch size.

    Images are collated into batches of ``batch_size``; a short last batch
    is padded by repeating its last image and the padding's results are
    dropped.  Every batch is launched before any result is copied back, so
    the host prepares the next batch while the card runs the last.
    Thresholds default to the config's test_cfg (score 0, soft-NMS at iou
    0.8).  ``device`` must be the model's; CUDA by default, and without a
    card it raises.

    ``compiled_fn`` replaces the model's forward: an exported program
    (``runtime.aot.compile_forward`` / ``load_executable``) whose inputs are
    fixed, so the images are cast to its ``input_dtype``.  With
    ``device_preprocess=True`` the forward takes (canvas (bs, H, W, 3)
    uint8, thw (bs, 2) int32): a ``compiled_fn`` must then have been
    exported with ``fuse_preprocess=True``.  ``classes`` names the labels
    for ``visualize``.
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
        classes: Sequence[str] = COCO_CLASSES,
        compiled_fn: Optional[Callable] = None,
        input_dtype: torch.dtype = torch.float32,
        device_preprocess: bool = False,
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
        self.classes = list(classes)
        self.input_dtype = input_dtype
        self.device_preprocess = device_preprocess
        if compiled_fn is None and device_preprocess:
            mean, std = tuple(self.cfg.preprocess.mean), tuple(self.cfg.preprocess.std)

            def compiled_fn(canvas, thw):
                x, m = preprocess_in_graph(canvas, thw, mean=mean, std=std)
                return model(x.to(input_dtype), m)

        self._fwd = model if compiled_fn is None else compiled_fn

    def _inputs(self, chunk):
        """One batch's forward arguments and (bs, 1, 4) scale factors."""
        if self.device_preprocess:
            pre = [resize_to_canvas(im, self.height, self.width, device=self.device) for im in chunk]
            args = (torch.stack([p[0] for p in pre]),
                    torch.tensor([p[1] for p in pre], dtype=torch.int32, device=self.device))
            sfs = [p[2] for p in pre]
        else:
            pre = [preprocess(im, self.height, self.width, self.cfg.preprocess, device=self.device)
                   for im in chunk]
            args = (torch.stack([p[0] for p in pre]).to(self.input_dtype),
                    torch.stack([p[1] for p in pre]))
            sfs = [p[2] for p in pre]
        sf = torch.tensor([[s[0], s[1], s[0], s[1]] for s in sfs], dtype=torch.float32,
                          device=self.device)[:, None, :]
        return args, sf

    @torch.inference_mode()
    def __call__(self, images: Sequence[np.ndarray]) -> List[Detections]:
        """images: (H, W, 3) RGB uint8 arrays, any count."""
        bs = self.batch_size
        head = self.cfg.head
        pending = []
        for i in range(0, len(images), bs):
            chunk = list(images[i:i + bs])
            n = len(chunk)
            chunk += [chunk[-1]] * (bs - n)  # pad by repeating the last image
            with annotate("preprocess"):
                args, sf = self._inputs(chunk)
            with annotate("forward"):
                boxes, scores, labels = self._fwd(*args)
            with annotate("postprocess"):
                post = postprocess_detections(
                    boxes, scores, labels,
                    score_threshold=self.score_threshold,
                    iou_threshold=self.iou_threshold,
                    scale_factor=sf,
                    nms_type=self.nms_type,
                    nms_sigma=head.nms_sigma,
                    nms_min_score=head.nms_min_score,
                )
            pending.append((n, post))
        outs: List[Detections] = []
        for n, post in pending:
            b, s, l, keep = (t.cpu().numpy() for t in post)
            outs.extend(Detections(b[j], s[j], l[j], keep[j]) for j in range(n))
        return outs

    def dump_json(self, detections: Sequence[Detections], path: str) -> None:
        with open(path, "w") as f:
            json.dump([d.to_dict() for d in detections], f, indent=2)

    def visualize(self, image: np.ndarray, det: Detections, out_path: Optional[str] = None) -> np.ndarray:
        """The image with ``det``'s kept boxes drawn; written to ``out_path``
        if given (needs OpenCV)."""
        from codetr_torch.utils.visualize import draw_detections, import_cv2

        vis = draw_detections(image, det, self.classes)
        if out_path:
            import_cv2().imwrite(out_path, vis[..., ::-1])  # RGB -> BGR on disk
        return vis
