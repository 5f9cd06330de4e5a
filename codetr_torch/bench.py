"""The on-card MSDA numerics gate, the counterpart of the JAX package's
``bench.py --verify`` (``verify_pallas_on_chip``).

``verify_msda_on_card(height, width, dtype)`` builds the encoder's MSDA
inputs at a resolution (5 levels at strides 4..64, 8 heads, 4 points, head
dim 32; each tap at its query's anchor on the target level plus up to 3 px
of uniform jitter; weights normalised per head; numpy seed 0, the same
draws as the JAX gate) and holds the q-minor entry ``msda_grid_qm`` and the
packed entry ``msda_grid_packed`` against the plain ``msda_reference_qm``,
within the JAX gate's tolerances.  Only the gate is ported; the JAX
script's timing, canary and sane-window search are not.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from codetr_torch.models.codetr import check_device
from codetr_torch.ops import msda
from codetr_torch.ops.msda_grid import _anchor

STRIDES = (4, 8, 16, 32, 64)  # the 5-scale neck's levels
HEADS, POINTS, HEAD_DIM = 8, 4, 32
JITTER_PX = 3.0
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 1e-2}  # max abs error


def verify_inputs(height: int, width: int, dtype=torch.float32, device="cuda"):
    """-> (value (1, K, 8, 32) in ``dtype``, spatial_shapes, x, y, w), the
    coordinates q-minor (1, 8, 5, 4, K) fp32, on ``device``."""
    device = check_device(device)
    shapes = tuple((-(-height // s), -(-width // s)) for s in STRIDES)
    K = sum(hh * ww for hh, ww in shapes)
    h, P, L, d = HEADS, POINTS, len(shapes), HEAD_DIM
    rng = np.random.default_rng(0)
    value = rng.standard_normal((1, K, h, d))
    x = np.zeros((1, h, L, P, K), np.float32)
    y = np.zeros_like(x)
    q0 = 0
    for Hq, Wq in shapes:
        iy, ix = np.meshgrid(np.arange(Hq), np.arange(Wq), indexing="ij")
        for lt, (Ht, Wt) in enumerate(shapes):
            ay = _anchor(iy, Hq, Ht).reshape(-1)
            ax = _anchor(ix, Wq, Wt).reshape(-1)
            y[0, :, lt, :, q0:q0 + Hq * Wq] = (ay + rng.uniform(-JITTER_PX, JITTER_PX, (h, P, Hq * Wq)) + 0.5) / Ht
            x[0, :, lt, :, q0:q0 + Hq * Wq] = (ax + rng.uniform(-JITTER_PX, JITTER_PX, (h, P, Hq * Wq)) + 0.5) / Wt
        q0 += Hq * Wq
    w = rng.uniform(0, 1, (1, h, L, P, K)).astype(np.float32)
    w /= w.sum(axis=(2, 3), keepdims=True)
    value = torch.from_numpy(value.astype(np.float32)).to(device, dtype)
    return (value, shapes, *(torch.from_numpy(a).to(device) for a in (x, y, w)))


def verify_msda_on_card(height: int, width: int, dtype=torch.float32, device="cuda") -> Dict[str, float]:
    """The gate at ``height`` x ``width``: raises on a mismatch, else returns
    the max abs errors of the q-minor and packed entries against the plain
    version and the mean |output|."""
    value, shapes, x, y, w = verify_inputs(height, width, dtype, device)
    want = msda.msda_reference_qm(value, shapes, x, y, w).float()
    got = msda.msda_grid_qm(value, shapes, x, y, w).float()
    got_packed = msda.msda_grid_packed(value, shapes, msda.pack_coords_qmajor(x, y, w), POINTS).float()
    errs = {
        "max_abs_err": (got - want).abs().max().item(),
        "max_abs_err_packed": (got_packed - want).abs().max().item(),
        "mean_abs_out": want.abs().double().mean().item(),
    }
    tol = TOLERANCE[dtype]
    for key in ("max_abs_err", "max_abs_err_packed"):
        if not errs[key] <= tol:
            raise AssertionError(f"MSDA gate at {height}x{width} {dtype}: {key} {errs[key]} (tol {tol})")
    return errs
