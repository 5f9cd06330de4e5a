"""Shared transformer bricks, batch-first, with mmdet's checkpoint key schema.

FFN keeps mmcv's ``layers.0.0`` / ``layers.1`` Linear names and
MultiheadAttention keeps torch's packed ``attn.in_proj_weight``, so a module
tree built from these bricks loads an mmdet state dict as it is.
Normalisation, attention logits and softmax run in float32 whatever the
compute dtype, where the JAX package's do: ``LayerNorm`` normalises in
float32 on float32 parameters and rounds once (flax's ``LayerNorm`` with
``param_dtype=float32``), and the logits are float32 products of the
compute-dtype projections (``preferred_element_type=float32``), never
rounded to bf16.
"""

from __future__ import annotations

import struct
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

# torch defaults, the same as the JAX package's
LN_EPS = 1e-5
GN_EPS = 1e-5


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in float32, on float32 copies of the input
    and of the affine parameters, and rounded once to the input's dtype: in
    a bf16 model the mean, the variance, the scale and the bias never pass
    through bf16 (the parameters stay float32 there: ``models.codetr.
    fp32_parameter_names``).  Unchanged for float32 inputs."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(),
                            self.eps).to(x.dtype)


def float32_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``q @ k^T`` as float32: the products of the two compute-dtype tensors
    summed in float32 and kept there (the JAX package's einsum with
    ``preferred_element_type=float32``).  A product of two bf16 numbers is
    exact in float32, so only the order of the sum differs."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def scalar_in(x: float, dtype: torch.dtype) -> float:
    """The number ``x`` rounded to ``dtype`` (float32 or bfloat16, to
    nearest, ties to even): the factor a JAX expression ``t * x`` uses, a
    Python scalar taking ``t``'s dtype there.  PyTorch multiplies a bf16
    tensor by ``x`` at float32 precision, so a bf16 model passes it through
    this first.  Pure Python: the result is a constant of an exported graph."""
    bits = struct.unpack("<I", struct.pack("<f", x))[0]
    if dtype == torch.bfloat16:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    elif dtype != torch.float32:
        raise ValueError(f"float32 or bfloat16, got {dtype}")
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def top_k(x: torch.Tensor, k: int, dtype: torch.dtype):
    """The ``k`` largest entries of each row of ``x`` (bs, n) and their
    indices, for scores computed in ``dtype``.  bf16 scores take a few
    hundred values an octave and tie often: equal entries are taken in
    index order, ``jax.lax.top_k``'s rule (a stable sort), where
    ``torch.topk`` may take any of them.  float32 ones keep ``torch.topk``:
    their ties are rare, and one between two proposals of the rehearsal's
    float32 model (``chip_smoke.py``) that the host's ``torch.topk`` ordered
    as the card's near-tie falls apart under the stable sort."""
    if dtype != torch.bfloat16:
        return torch.topk(x, k, dim=1)
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


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
        logits = float32_logits(q, k) * (1.0 / d**0.5)
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
