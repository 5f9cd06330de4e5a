"""Shared transformer bricks, batch-first, with mmdet's checkpoint key schema.

FFN keeps mmcv's ``layers.0.0`` / ``layers.1`` Linear names and
MultiheadAttention keeps torch's packed ``attn.in_proj_weight``, so a module
tree built from these bricks loads an mmdet state dict as it is.
Normalisation and softmax run in float32 whatever the compute dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# torch defaults, the same as the JAX package's
LN_EPS = 1e-5
GN_EPS = 1e-5


def mlp(in_dim: int, hidden_dim: int, out_dim: int, num_layers: int) -> nn.Sequential:
    """DETR-style MLP, (num_layers-1) x [Linear, ReLU] + Linear; as an
    ``nn.Sequential`` its Linear layers sit at indices 0, 2, 4, ... like
    mmdet's reg branches and ref_point_head."""
    layers = []
    dims = [in_dim] + [hidden_dim] * (num_layers - 1)
    for i, d in enumerate(dims):
        if i:
            layers.append(nn.ReLU())
        layers.append(nn.Linear(d, hidden_dim if i < num_layers - 1 else out_dim))
    return nn.Sequential(*layers)


class FFN(nn.Module):
    """Linear -> activation -> Linear, with an optional residual (mmcv FFN;
    relu in the transformer, exact gelu in Swin)."""

    def __init__(self, embed_dims: int, feedforward_channels: int, activation: str = "relu",
                 add_identity: bool = True):
        super().__init__()
        act = nn.ReLU() if activation == "relu" else nn.GELU(approximate="none")
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels), act),
            nn.Linear(feedforward_channels, embed_dims),
        )
        self.add_identity = add_identity

    def forward(self, x: torch.Tensor, identity: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.layers(x)
        if not self.add_identity:
            return out
        return (x if identity is None else identity) + out


class _PackedAttention(nn.Module):
    """Parameter holder with torch.nn.MultiheadAttention's names, and the
    packed input projection.  ``parallel/mesh.py:shard_params`` swaps in a
    subclass whose weight rows are split over the tensor-parallel ranks."""

    def __init__(self, embed_dims: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims))
        self.out_proj = nn.Linear(embed_dims, embed_dims)

    def project(self, qk_in: torch.Tensor, query: torch.Tensor):
        """q, k, v: rows [0, 2E) of the packed weight on ``qk_in``, rows
        [2E, 3E) on ``query``."""
        E = self.in_proj_weight.shape[1]
        w, b = self.in_proj_weight, self.in_proj_bias
        return (F.linear(qk_in, w[:E], b[:E]), F.linear(qk_in, w[E:2 * E], b[E:2 * E]),
                F.linear(query, w[2 * E:], b[2 * E:]))


class MultiheadAttention(nn.Module):
    """Dense multi-head self-attention with residual: q = k = query + pos,
    v = query; plain matmul + float32 softmax."""

    def __init__(self, embed_dims: int, num_heads: int):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.attn = _PackedAttention(embed_dims)

    def forward(self, query: torch.Tensor, query_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
        E, nh = self.embed_dims, self.num_heads
        d = E // nh
        qk_in = query if query_pos is None else query + query_pos
        q, k, v = self.attn.project(qk_in, query)
        bs, nq, _ = q.shape
        q, k, v = (t.reshape(bs, nq, nh, d).transpose(1, 2) for t in (q, k, v))
        logits = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / d**0.5)
        attn = logits.softmax(-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(bs, nq, E)
        return query + self.attn.out_proj(out)


def corner_pad_to_multiple(x_nhwc: torch.Tensor, multiple_h: int, multiple_w: int) -> torch.Tensor:
    """Zero-pad bottom/right so H, W become multiples (AdaptivePadding 'corner')."""
    H, W = x_nhwc.shape[1], x_nhwc.shape[2]
    pad_h, pad_w = (-H) % multiple_h, (-W) % multiple_w
    if pad_h or pad_w:
        x_nhwc = F.pad(x_nhwc, (0, 0, 0, pad_w, 0, pad_h))
    return x_nhwc


def nearest_resize_mask(mask: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """F.interpolate(mode='nearest') of (bs, H, W) masks: index
    floor(out_idx * in / out), computed in float32 as the JAX package does."""
    H, W = mask.shape[1], mask.shape[2]
    dev = mask.device
    rows = torch.floor(torch.arange(out_h, device=dev, dtype=torch.float32) * (H / out_h)).long()
    cols = torch.floor(torch.arange(out_w, device=dev, dtype=torch.float32) * (W / out_w)).long()
    return mask[:, rows][:, :, cols]


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps)) - torch.log((1 - x).clamp(min=eps))
