"""Swin Transformer backbone.

Tokens stay channels-last (B, H, W, C) between blocks; only the patch
embedding's convolution runs NCHW.  Module names follow mmdet's checkpoint
keys (``stages.i.blocks.j.attn.w_msa.qkv``, ``stages.i.downsample.reduction``,
``norm{i}``).  Features come out NCHW at strides 4/8/16/32.

- Window attention adds the relative-position bias; shifted windows use the
  static -100 region mask; maps are corner-padded to a window multiple.
- PatchMerging concatenates each 2x2 neighbourhood in ``nn.Unfold``'s
  channel-major order (channel c of position p lands at c*4 + p), as mmdet
  checkpoints expect.
- Dropout and stochastic depth are left out (inert at inference; the JAX
  package's training path runs without them too).
- ``SwinConfig.with_cp`` recomputes each block's activations in the
  backward pass (``torch.utils.checkpoint``) when gradients are on.
"""

from __future__ import annotations

import functools
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from codetr_torch.config import SwinConfig
from codetr_torch.models.layers import FFN, LN_EPS, corner_pad_to_multiple


def relative_position_index(ws: int) -> torch.Tensor:
    """(N, N) index into the (2ws-1)^2 bias table:
    (yi - yj + ws - 1) * (2ws - 1) + (xi - xj + ws - 1)."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)


@functools.lru_cache(maxsize=16)
def _shift_mask_cached(h_pad: int, w_pad: int, window: int, shift: int,
                       device: torch.device) -> torch.Tensor:
    return _shift_mask(h_pad, w_pad, window, shift, device)


def _shift_mask(h_pad: int, w_pad: int, window: int, shift: int, device: torch.device) -> torch.Tensor:
    img = np.zeros((h_pad, w_pad), dtype=np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for wsl in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    img = img.reshape(h_pad // window, window, w_pad // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)  # (nW, N)
    diff = img[:, None, :] - img[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32)).to(device)


def shifted_window_attn_mask(h_pad: int, w_pad: int, window: int, shift: int,
                             device: torch.device) -> torch.Tensor:
    """(nW, N, N) additive mask: 0 within a region, -100 across regions.
    Cached per shape and device: it is a constant of the input size.  While
    ``torch.export`` traces, it is made anew (a constant of the program): a
    cached tensor from a trace is a fake one."""
    if torch.compiler.is_compiling():
        return _shift_mask(h_pad, w_pad, window, shift, device)
    return _shift_mask_cached(h_pad, w_pad, window, shift, device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, window*window, C)."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(windows: torch.Tensor, window: int, H: int, W: int) -> torch.Tensor:
    """(B*nW, window*window, C) -> (B, H, W, C)."""
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // window) * (W // window))
    x = windows.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowMSA(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, window_size: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.scale = qk_scale or (embed_dims // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads)
        )
        self.register_buffer("relative_position_index", relative_position_index(window_size),
                             persistent=False)
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims, bias=qkv_bias)
        self.proj = nn.Linear(embed_dims, embed_dims)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q * self.scale, k.transpose(-2, -1)).float()
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(N, N, h).permute(2, 0, 1)[None].float()
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B // nW, nW, h, N, N) + mask[None, :, None]).reshape(B, h, N, N)
        attn = attn.softmax(-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, window_size: int, shift_size: int,
                 qkv_bias: bool, qk_scale: Optional[float]):
        super().__init__()
        self.window_size, self.shift_size = window_size, shift_size
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size, qkv_bias, qk_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, shift = self.window_size, self.shift_size
        x = corner_pad_to_multiple(x, ws, ws)
        H_pad, W_pad = x.shape[1], x.shape[2]
        mask = None
        if shift > 0:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
            mask = shifted_window_attn_mask(H_pad, W_pad, ws, shift, x.device)
        x = window_reverse(self.w_msa(window_partition(x, ws), mask), ws, H_pad, W_pad)
        if shift > 0:
            x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
        return x[:, :H, :W, :]


class SwinBlock(nn.Module):
    """LN -> (S)W-MSA -> +res -> LN -> FFN(gelu) -> +res."""

    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 window_size: int, shift: bool, qkv_bias: bool, qk_scale: Optional[float]):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size,
                                   window_size // 2 if shift else 0, qkv_bias, qk_scale)
        self.norm2 = nn.LayerNorm(embed_dims, eps=LN_EPS)
        self.ffn = FFN(embed_dims, feedforward_channels, activation="gelu", add_identity=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class PatchEmbed(nn.Module):
    """Corner pad + conv(k=s=patch) + LN; NHWC in, NHWC out."""

    def __init__(self, in_channels: int, embed_dims: int, patch_size: int):
        super().__init__()
        self.patch_size = patch_size
        self.projection = nn.Conv2d(in_channels, embed_dims, patch_size, patch_size)
        self.norm = nn.LayerNorm(embed_dims, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = corner_pad_to_multiple(x, self.patch_size, self.patch_size)
        x = self.projection(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.norm(x)


class PatchMerging(nn.Module):
    """2x2 neighbourhood -> LN -> Linear(4C -> 2C, no bias), unfold order."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * in_channels, eps=LN_EPS)
        self.reduction = nn.Linear(4 * in_channels, out_channels, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = corner_pad_to_multiple(x, 2, 2)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4)
        x = x.reshape(B, H // 2, W // 2, 4 * C)  # channel c, offset (dy, dx) -> c*4 + dy*2 + dx
        return self.reduction(self.norm(x))


class SwinBlockSequence(nn.Module):
    def __init__(self, embed_dims: int, num_heads: int, depth: int, cfg: SwinConfig,
                 downsample: bool):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(embed_dims, num_heads, cfg.mlp_ratio * embed_dims, cfg.window_size,
                      shift=i % 2 == 1, qkv_bias=cfg.qkv_bias, qk_scale=cfg.qk_scale)
            for i in range(depth)
        )
        self.downsample = PatchMerging(embed_dims, 2 * embed_dims) if downsample else None


class SwinTransformer(nn.Module):
    def __init__(self, cfg: SwinConfig):
        super().__init__()
        self.cfg = cfg
        self.patch_embed = PatchEmbed(cfg.in_channels, cfg.embed_dims, cfg.patch_size)
        n = len(cfg.depths)
        self.stages = nn.ModuleList(
            SwinBlockSequence(cfg.num_features[i], cfg.num_heads[i], depth, cfg,
                              downsample=i < n - 1)
            for i, depth in enumerate(cfg.depths)
        )
        for i in cfg.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(cfg.num_features[i], eps=LN_EPS))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x: (B, H, W, 3) -> NCHW feature maps of the out_indices stages."""
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                if self.cfg.with_cp and torch.is_grad_enabled():
                    x = checkpoint(block, x, use_reentrant=False)
                else:
                    x = block(x)
            if i in self.cfg.out_indices:
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2).contiguous())
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs
