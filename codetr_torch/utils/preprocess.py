"""Image preprocessing in torch: keep-ratio resize -> corner pad ->
normalise -> pad mask (0 inside the image, 1 in the padding).

The resize is cv2 ``INTER_LINEAR``'s fixed-point arithmetic on uint8
images, written out in integer torch ops (``resize_linear_u8``), so the
port's pixels equal the JAX package's host resize (``cv2.resize``) bit for
bit.  It runs on the device it is given.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from codetr_torch.config import PreprocessConfig
from codetr_torch.models.codetr import check_device


def rescale_size(old_w: int, old_h: int, new_w: int, new_h: int) -> Tuple[int, int]:
    """mmcv keep-ratio resize target: scale by min(new/old) and round."""
    scale = min(new_w / old_w, new_h / old_h)
    return int(old_w * scale + 0.5), int(old_h * scale + 0.5)


_COEF_BITS = 11  # cv2's INTER_RESIZE_COEF_BITS: 2048 = 1.0


def _linear_taps(src: int, dst: int, clamp: bool):
    """cv2 ``INTER_LINEAR``'s taps on one axis: per output index its two
    source indices and their 11-bit coefficients (int64 numpy).  The
    position ``(d + 0.5) * src / dst - 0.5`` is taken in double and rounded
    to float, its fraction rounded to the nearest 1/2048 (ties to even).
    On the horizontal axis (``clamp``) a position outside ``[0, src - 1]``
    snaps to the border pixel with fraction 0; on the vertical one cv2
    keeps the fraction and clamps only the rows."""
    f = ((np.arange(dst) + 0.5) * (src / dst) - 0.5).astype(np.float32)
    s = np.floor(f)
    f = f - s
    s = s.astype(np.int64)
    if clamp:
        f = np.where((s < 0) | (s >= src - 1), np.float32(0), f)
        s = np.clip(s, 0, src - 1)
    scale = np.float32(1 << _COEF_BITS)
    a1 = np.rint(f * scale).astype(np.int64)
    a0 = np.rint((np.float32(1) - f) * scale).astype(np.int64)
    return np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), a0, a1


def resize_linear_u8(img: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """(H, W, C) uint8 -> (th, tw, C) uint8, as ``cv2.resize(img, (tw, th),
    interpolation=cv2.INTER_LINEAR)`` computes it: a horizontal pass of
    11-bit coefficients into int sums, then cv2's vectorised vertical pass,
    ``(((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2``
    saturated to uint8.  Any device."""
    H, W = img.shape[:2]
    dev = img.device
    sx0, sx1, ax0, ax1 = (torch.from_numpy(a).to(dev) for a in _linear_taps(W, tw, True))
    sy0, sy1, ay0, ay1 = (torch.from_numpy(a).to(dev) for a in _linear_taps(H, th, False))
    x = img.to(torch.int32)
    rows = x[:, sx0] * ax0.view(1, -1, 1).int() + x[:, sx1] * ax1.view(1, -1, 1).int()
    b0, b1 = ay0.view(-1, 1, 1).int(), ay1.view(-1, 1, 1).int()
    v = ((b0 * (rows[sy0] >> 4)) >> 16) + ((b1 * (rows[sy1] >> 4)) >> 16)
    return ((v + 2) >> 2).clamp(0, 255).to(torch.uint8)


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
    resized = resize_linear_u8(img, th, tw).float()  # (th, tw, 3)

    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=img.device)
    std = torch.tensor(cfg.std, dtype=torch.float32, device=img.device)
    out = torch.zeros(height, width, 3, dtype=torch.float32, device=img.device)
    out[:th, :tw] = (resized - mean) / std
    mask = torch.ones(height, width, dtype=torch.float32, device=img.device)
    mask[:th, :tw] = 0.0
    return out, mask, (tw / ow, th / oh), (th, tw)
