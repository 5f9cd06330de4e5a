"""Image preprocessing in torch: keep-ratio resize -> corner pad ->
normalise -> pad mask (0 inside the image, 1 in the padding).

The resize is ``F.interpolate(mode='bilinear', align_corners=False,
antialias=False)`` of the uint8 image followed by rounding half up: cv2
``INTER_LINEAR``'s half-pixel mapping, equal to it up to cv2's fixed-point
coefficients (within one uint8 level).  It runs on the device it is given.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from codetr_torch.config import PreprocessConfig
from codetr_torch.models.codetr import check_device


def rescale_size(old_w: int, old_h: int, new_w: int, new_h: int) -> Tuple[int, int]:
    """mmcv keep-ratio resize target: scale by min(new/old) and round."""
    scale = min(new_w / old_w, new_h / old_h)
    return int(old_w * scale + 0.5), int(old_h * scale + 0.5)


def preprocess(
    image_rgb,
    height: int,
    width: int,
    cfg: PreprocessConfig = PreprocessConfig(),
    keep_ratio: bool = True,
    device="cuda",
):
    """image (H, W, 3) RGB uint8 (numpy or tensor) -> (inputs (height, width,
    3) float32, mask (height, width) float32, scale_factor (w_scale,
    h_scale), unpadded (th, tw)); tensors on ``device`` (the card by
    default; raises if there is none)."""
    device = check_device(device)
    img = torch.as_tensor(np.asarray(image_rgb) if not torch.is_tensor(image_rgb) else image_rgb)
    if img.dtype != torch.uint8 or img.dim() != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {tuple(img.shape)} {img.dtype}")
    img = img.to(device)
    oh, ow = img.shape[:2]
    tw, th = rescale_size(ow, oh, width, height) if keep_ratio else (width, height)
    chw = img.permute(2, 0, 1)[None].float()
    resized = F.interpolate(chw, size=(th, tw), mode="bilinear", align_corners=False,
                            antialias=False)
    resized = torch.floor(resized + 0.5).clamp(0, 255)[0].permute(1, 2, 0)  # (th, tw, 3)

    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=img.device)
    out = torch.zeros(height, width, 3, dtype=torch.float32, device=img.device)
    out[:th, :tw] = (resized - mean) / std
    mask = torch.ones(height, width, dtype=torch.float32, device=img.device)
    mask[:th, :tw] = 0.0
    return out, mask, (tw / ow, th / oh), (th, tw)
