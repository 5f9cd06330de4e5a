"""ChannelMapper neck, NCHW: per backbone level a 1x1 conv + GroupNorm, then
one extra level from a 3x3 stride-2 conv + GroupNorm on the last input map.
The GroupNorm normalises in float32 on float32 parameters in every compute
dtype and rounds once, as the JAX package's (flax, ``param_dtype=float32``)
does."""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from codetr_torch.config import NeckConfig
from codetr_torch.models.layers import GN_EPS


class ConvGN(nn.Module):
    def __init__(self, c_in: int, c_out: int, kernel_size: int, stride: int, groups: int):
        super().__init__()
        self.conv = nn.Conv2d(c_in, c_out, kernel_size, stride, padding=kernel_size // 2)
        self.gn = nn.GroupNorm(groups, c_out, eps=GN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the op F.group_norm calls, without its refusal of a group of one
        # element (a 1x1 level with a channel a group, as the tiny config
        # gives at 32x32), which normalises to the bias, as the JAX
        # package's GroupNorm does
        gn = self.gn
        y = self.conv(x)
        return torch.group_norm(y.float(), gn.num_groups, gn.weight.float(), gn.bias.float(), gn.eps,
                                torch.backends.cudnn.enabled).to(y.dtype)


class ChannelMapper(nn.Module):
    def __init__(self, cfg: NeckConfig):
        super().__init__()
        self.cfg = cfg
        self.convs = nn.ModuleList(
            ConvGN(c, cfg.out_channels, cfg.kernel_size, 1, cfg.num_groups) for c in cfg.in_channels
        )
        self.extra_convs = nn.ModuleList(
            ConvGN(cfg.in_channels[-1] if j == 0 else cfg.out_channels, cfg.out_channels, 3, 2,
                   cfg.num_groups)
            for j in range(cfg.num_outs - len(cfg.in_channels))
        )

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(feats) != len(self.cfg.in_channels):
            raise ValueError(f"expected {len(self.cfg.in_channels)} levels, got {len(feats)}")
        outs = [m(x) for m, x in zip(self.convs, feats)]
        for j, m in enumerate(self.extra_convs):
            outs.append(m(feats[-1] if j == 0 else outs[-1]))
        return outs
