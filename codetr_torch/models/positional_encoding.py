"""Sine positional encodings, computed in float32.

- ``sine_positional_encoding``: cumsum-over-mask image encoding, returned
  channels-last as (bs, H, W, 2*num_feats).
- ``gen_sineembed_for_position``: box-coordinate sine embedding for the
  decoder's ref_point_head, batch-first.
"""

from __future__ import annotations

import math

import torch

from codetr_torch.config import PositionalEncodingConfig


def _interleave_sin_cos(p: torch.Tensor) -> torch.Tensor:
    """(..., F) -> (..., F): sin of even features, cos of odd ones, interleaved."""
    return torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()), dim=-1).flatten(-2)


def sine_positional_encoding(
    mask: torch.Tensor, cfg: PositionalEncodingConfig, dtype=torch.float32
) -> torch.Tensor:
    """mask: (bs, H, W), nonzero = padded.  Returns (bs, H, W, 2*num_feats)."""
    not_mask = 1.0 - mask.float()
    y_embed = not_mask.cumsum(1)
    x_embed = not_mask.cumsum(2)
    if cfg.normalize:
        y_embed = (y_embed + cfg.offset) / (y_embed[:, -1:, :] + cfg.eps) * cfg.scale
        x_embed = (x_embed + cfg.offset) / (x_embed[:, :, -1:] + cfg.eps) * cfg.scale
    dim_t = torch.arange(cfg.num_feats, dtype=torch.float32, device=mask.device)
    dim_t = cfg.temperature ** (2.0 * torch.floor(dim_t / 2.0) / cfg.num_feats)
    pos_x = _interleave_sin_cos(x_embed[..., None] / dim_t)
    pos_y = _interleave_sin_cos(y_embed[..., None] / dim_t)
    return torch.cat((pos_y, pos_x), dim=3).to(dtype)


def gen_sineembed_for_position(pos_tensor: torch.Tensor, pos_feat: int) -> torch.Tensor:
    """pos_tensor (bs, nq, 2 or 4) normalised coords ->
    (bs, nq, pos_feat * pos_tensor.shape[-1]), ordered y, x[, w, h]."""
    dim_t = torch.arange(pos_feat, dtype=torch.float32, device=pos_tensor.device)
    dim_t = 10000.0 ** (2.0 * torch.floor(dim_t / 2.0) / pos_feat)

    def embed(coord):
        return _interleave_sin_cos(coord.float()[..., None] * (2.0 * math.pi) / dim_t)

    n = pos_tensor.shape[-1]
    if n not in (2, 4):
        raise ValueError(f"pos_tensor last dim must be 2 or 4, got {n}")
    order = (1, 0) if n == 2 else (1, 0, 2, 3)
    out = torch.cat([embed(pos_tensor[..., i]) for i in order], dim=2)
    return out.to(pos_tensor.dtype)
