"""ResNet backbone (R50 / R101), pytorch style, with frozen BatchNorm.

mmdet's ResNet as the R50 Co-DINO config builds it: depth 50, out_indices
(0, 1, 2, 3), BatchNorm frozen in its inference affine form, stride 2 on
each stage's first 3x3 conv and a 1x1 conv + BN downsample on every
stage's first block.  Module names are mmdet's (``conv1``, ``bn1``,
``layer{s}.{b}.conv{j}``, ``...downsample.0/1``), so ``state_dict()`` keys
are an mmdet R50 checkpoint's, less its ``num_batches_tracked`` counters.
Computes in NCHW; the input is the model's NHWC image batch.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from codetr_torch.config import ResNetConfig

BN_EPS = 1e-5


class FrozenBatchNorm2d(nn.Module):
    """Inference BatchNorm, y = (x - mean) / sqrt(var + eps) * weight + bias,
    its four tensors held as buffers under mmdet's names.  Computes in fp32
    and casts back to the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var.float() + BN_EPS) * self.weight.float()
        shift = self.bias.float() - self.running_mean.float() * inv
        return (x.float() * inv[:, None, None] + shift[:, None, None]).to(x.dtype)


def _conv(c_in: int, c_out: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, k, stride, padding=k // 2, bias=False)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, each with frozen BN, plus the identity or
    downsample shortcut."""

    def __init__(self, c_in: int, mid: int, c_out: int, stride: int, downsample: bool):
        super().__init__()
        self.conv1, self.bn1 = _conv(c_in, mid, 1), FrozenBatchNorm2d(mid)
        self.conv2, self.bn2 = _conv(mid, mid, 3, stride), FrozenBatchNorm2d(mid)
        self.conv3, self.bn3 = _conv(mid, c_out, 1), FrozenBatchNorm2d(c_out)
        self.downsample = (
            nn.Sequential(_conv(c_in, c_out, 1, stride), FrozenBatchNorm2d(c_out)) if downsample else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(identity + y)


class ResNet(nn.Module):
    def __init__(self, cfg: ResNetConfig):
        super().__init__()
        if cfg.style != "pytorch":
            raise ValueError(f"only the pytorch style is supported, got {cfg.style!r}")
        self.cfg = cfg
        self.conv1 = nn.Conv2d(cfg.in_channels, cfg.stem_channels, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBatchNorm2d(cfg.stem_channels)
        c_in = cfg.stem_channels
        for stage, num_blocks in enumerate(cfg.stage_blocks[:cfg.num_stages]):
            mid = cfg.base_channels * 2**stage
            blocks = []
            for b in range(num_blocks):
                stride = 2 if b == 0 and stage > 0 else 1
                blocks.append(Bottleneck(c_in, mid, 4 * mid, stride, downsample=b == 0))
                c_in = 4 * mid
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, 3) -> NCHW feature maps of the out_indices stages."""
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for stage in range(self.cfg.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
            if stage in self.cfg.out_indices:
                outs.append(x)
        return outs
