"""The Co-DINO training step with the query-head losses.

The port of the JAX package's ``parallel/train.py`` on one device:
``model.train_outputs`` (the per-layer and encoder-stage predictions before
top-k) -> ``dino_detection_loss`` (Hungarian matching + QFL / L1 / GIoU over
every decoder layer and the encoder stage) -> backward -> AdamW.  The step
runs on the model's device; on the card the MSDA forward and backward are
the hand-written kernels.  An fp32 model's step, backward included, runs in
full fp32 (``models.codetr.fp32_scope``: TF32 off for cuDNN and matmuls,
the caller's flags restored after).  The sharded (dp x tp) variants are not
ported.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from codetr_torch.models.codetr import fp32_scope
from codetr_torch.parallel.losses import dino_detection_loss


def adamw(model: nn.Module, lr: float = 1e-4) -> torch.optim.AdamW:
    """The optimizer equal to ``optax.adamw(lr)``: betas (0.9, 0.999), eps
    1e-8 and optax's weight decay of 1e-4 (not torch's default 0.01)."""
    return torch.optim.AdamW(
        model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4
    )


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable[..., torch.Tensor]:
    """Returns ``step(batch_inputs, img_masks, gt_boxes, gt_labels,
    gt_valid) -> loss``.  Targets: gt_boxes (bs, max_gt, 4) normalised
    cxcywh, gt_labels (bs, max_gt) int, gt_valid (bs, max_gt) bool, all on
    the model's device.

    Unlike the JAX package's pure step, this one updates the model's
    parameters and the optimizer's state in place; each parameter's
    ``.grad`` holds the gradient of the returned (detached) loss until the
    next step."""

    def step(batch_inputs, img_masks, gt_boxes, gt_labels, gt_valid) -> torch.Tensor:
        with fp32_scope(next(model.parameters()).dtype):
            optimizer.zero_grad(set_to_none=True)
            outputs = model.train_outputs(batch_inputs, img_masks)
            total, _ = dino_detection_loss(outputs, gt_boxes, gt_labels, gt_valid)
            total.backward()
            optimizer.step()
        return total.detach()

    return step
