"""ctypes bindings for the port's native host library
(``codetr_torch/csrc/codetr_host.cpp``): the keep-ratio resize, normalise,
pad and mask of ``codetr_preprocess`` and the greedy per-class NMS of
``codetr_batched_nms``, the host work that the native runner
(``csrc/codetr_aoti_runner.cpp``) does around the AOTInductor package.

The library is built at first use by ``ops/_build.py:build_host`` (``g++``,
no nvcc) into ``codetr_torch/_build/``.  Nothing falls back: a library
that does not build or load raises, and so does a failed call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from codetr_torch.ops import _build

VERSION = b"codetr-torch-host-0.1.0"

_f32p = ctypes.POINTER(ctypes.c_float)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_libs: dict = {}


def load_host_library(path: Optional[str] = None) -> ctypes.CDLL:
    """The host library at ``path`` (by default ``build_host()``'s, built
    now if needed), loaded with its functions' argument and return types
    declared.  Raises if it cannot be built or loaded."""
    path = str(path or _build.build_host().path)
    if path in _libs:
        return _libs[path]
    lib = ctypes.CDLL(path)
    lib.codetr_preprocess.restype = ctypes.c_int
    lib.codetr_preprocess.argtypes = [
        _u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, ctypes.c_int, _f32p, _f32p, _f32p, _i32p,
    ]
    lib.codetr_batched_nms.restype = ctypes.c_int
    lib.codetr_batched_nms.argtypes = [
        _f32p, _f32p, _i32p, ctypes.c_int, ctypes.c_float, ctypes.c_float, _u8p,
    ]
    lib.codetr_host_version.restype = ctypes.c_char_p
    lib.codetr_host_version.argtypes = []
    _libs[path] = lib
    return lib


def preprocess_native(
    image_rgb: np.ndarray, height: int, width: int, mean, std, keep_ratio: bool = True
) -> Tuple[np.ndarray, np.ndarray, Tuple[float, float], Tuple[int, int]]:
    """image (H, W, 3) RGB uint8 -> (inputs (height, width, 3) float32,
    mask (height, width) float32, 1 in the padding, scale_factor (w_scale,
    h_scale), resized (th, tw)), as ``utils/preprocess.py:preprocess``
    returns them, computed on the host by ``codetr_preprocess``."""
    img = np.ascontiguousarray(image_rgb, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {img.shape}")
    ih, iw = img.shape[:2]
    out = np.empty((height, width, 3), np.float32)
    mask = np.empty((height, width), np.float32)
    scale = np.empty(2, np.float32)
    resized = np.empty(2, np.int32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (3,) or std.shape != (3,):
        raise ValueError(f"mean and std need 3 values each, got {mean.shape} and {std.shape}")
    rc = load_host_library().codetr_preprocess(
        img.ctypes.data_as(_u8p), ih, iw, height, width,
        mean.ctypes.data_as(_f32p), std.ctypes.data_as(_f32p), 1 if keep_ratio else 0,
        out.ctypes.data_as(_f32p), mask.ctypes.data_as(_f32p),
        scale.ctypes.data_as(_f32p), resized.ctypes.data_as(_i32p),
    )
    if rc != 0:
        raise RuntimeError(f"codetr_preprocess failed ({rc}) on a {ih}x{iw} image to {height}x{width}")
    return out, mask, (float(scale[0]), float(scale[1])), (int(resized[0]), int(resized[1]))


def _host(a, dtype) -> np.ndarray:
    """``a`` (a numpy array, or a torch tensor on any device and of any
    dtype, bf16 included) as a contiguous host array of ``dtype``: what
    the native runner does to a package's outputs before its NMS."""
    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float32 if a.is_floating_point() else torch.int64).numpy()
    return np.ascontiguousarray(a, dtype)


def batched_nms_native(
    boxes, scores, labels, iou_threshold: float, score_threshold: float = -np.inf,
) -> np.ndarray:
    """Greedy per-class NMS of (N, 4) xyxy boxes -> keep (N,) bool: boxes
    in descending score order (ties by index) are kept unless a kept box of
    their label overlaps them by more than ``iou_threshold``; scores below
    ``score_threshold`` or not finite are dropped.  Numpy arrays or torch
    tensors (a bf16 package's outputs too), read as float32 and int32."""
    boxes = _host(boxes, np.float32)
    scores = _host(scores, np.float32)
    labels = _host(labels, np.int32)
    n = len(boxes)
    if boxes.shape != (n, 4) or scores.shape != (n,) or labels.shape != (n,):
        raise ValueError(f"boxes (N, 4), scores (N,), labels (N,); got {boxes.shape}, {scores.shape}, "
                         f"{labels.shape}")
    keep = np.zeros(n, np.uint8)
    kept = load_host_library().codetr_batched_nms(
        boxes.ctypes.data_as(_f32p), scores.ctypes.data_as(_f32p), labels.ctypes.data_as(_i32p),
        n, float(iou_threshold),
        float(score_threshold) if np.isfinite(score_threshold) else -3.4e38,
        keep.ctypes.data_as(_u8p),
    )
    if kept < 0:
        raise RuntimeError(f"codetr_batched_nms failed ({kept})")
    return keep.astype(bool)
