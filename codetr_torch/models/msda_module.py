"""MultiScaleDeformableAttention module, batch-first.

Projections keep mmdet's names and layout; in particular the
sampling-offset columns stay interleaved (h, L, P, 2) as in mmdet
checkpoints.  Coordinates, offsets and attention weights are float32 in every
compute dtype (bf16 locations would quantise to ~0.6 px at stride 4).

With ``grid_queries=True`` (encoder self-attention, queries = the
level-concatenated pixel grid) and ``impl="auto"`` the coordinates are
packed into one (bs, K, 3*HLP) tensor [x(HLP) | y(HLP) | w(HLP)] for
``msda_grid_packed``; otherwise (decoder cross-attention, 4-coordinate
reference boxes) they go through the reference-layout
``multi_scale_deformable_attention``.  Both reach the same CUDA kernel on
the card.  With grid queries and ``impl="grid"`` or ``"grid_pallas"`` (the
JAX package's research shift-window paths) they take the JAX module's
q-minor pipeline into ``msda_grid_qm(impl=...)``: offsets divided by the
level sizes, the softmax over each head's taps on the q-minor layout, the
window radius ``grid_radius`` (None: ``cfg.grid_radius``).  Those impls
need grid queries: a module built with one and without them raises.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from codetr_torch.config import MSDAConfig
from codetr_torch.ops.msda import (
    GRID_MAX_WINDOW,
    msda_grid_packed,
    msda_grid_qm,
    multi_scale_deformable_attention,
)


def grid_offset_bias(num_heads: int, num_levels: int, num_points: int) -> torch.Tensor:
    """mmdet's sampling-offset bias init: unit directions at head angles,
    scaled by point index, interleaved (h, L, P, 2)."""
    thetas = torch.arange(num_heads, dtype=torch.float64) * (2.0 * math.pi / num_heads)
    grid = torch.stack([thetas.cos(), thetas.sin()], -1)
    grid = grid / grid.abs().max(-1, keepdim=True)[0]
    grid = grid[:, None, None, :].repeat(1, num_levels, num_points, 1)
    grid = grid * torch.arange(1, num_points + 1, dtype=torch.float64)[None, None, :, None]
    return grid.reshape(-1).float()


def _level_table(shapes: Tuple[Tuple[int, int], ...], kind: str, device: torch.device) -> torch.Tensor:
    rows = {"hw": [[hh, ww] for hh, ww in shapes],
            "wh": [[ww, hh] for hh, ww in shapes],
            "inv_wh": [[1.0 / ww, 1.0 / hh] for hh, ww in shapes]}[kind]
    return torch.tensor(rows, dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def _level_table_cached(shapes: Tuple[Tuple[int, int], ...], kind: str, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode (the
    # Inferencer's): an inference tensor cannot be saved for a backward pass
    with torch.inference_mode(False):
        return _level_table(shapes, kind, device)


def level_table(spatial_shapes: Sequence[Tuple[int, int]], kind: str, device: torch.device) -> torch.Tensor:
    """(L, 2) float32 table of the level sizes: per level (h, w) for ``kind``
    "hw", (w, h) for "wh", (1/w, 1/h) for "inv_wh".
    Cached per shapes and device: made from host data, it is a host-to-device
    copy that a CUDA-graph capture refuses, so a captured step must find it
    made by its warm-up.  While ``torch.export`` traces, it is made anew (a
    constant of the program), as ``swin.shifted_window_attn_mask`` is."""
    shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    if torch.compiler.is_compiling():
        return _level_table(shapes, kind, device)
    return _level_table_cached(shapes, kind, device)


class MultiScaleDeformableAttention(nn.Module):
    def __init__(self, cfg: MSDAConfig, grid_queries: bool = False, impl: str = "auto",
                 grid_radius: Optional[int] = None):
        super().__init__()
        if impl != "auto" and impl not in GRID_MAX_WINDOW:
            raise ValueError(f"unknown MSDA impl {impl!r}")
        if impl != "auto" and not grid_queries:
            raise ValueError(f"impl={impl!r} requires grid queries")
        self.cfg = cfg
        self.grid_queries = grid_queries
        self.impl = impl
        self.grid_radius = cfg.grid_radius if grid_radius is None else grid_radius
        E = cfg.embed_dims
        n = cfg.num_heads * cfg.num_levels * cfg.num_points
        self.sampling_offsets = nn.Linear(E, 2 * n)
        self.attention_weights = nn.Linear(E, n)
        self.value_proj = nn.Linear(E, int(E * cfg.value_proj_ratio))
        self.output_proj = nn.Linear(int(E * cfg.value_proj_ratio), E)

    def project_value(self, value: torch.Tensor, key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
        """(bs, nk, C) -> ``value_proj``, padded keys zeroed, split into
        heads: (bs, nk, h, C/h)."""
        v = self.value_proj(value)
        if key_padding_mask is not None:
            v = v.masked_fill(key_padding_mask[..., None], 0.0)
        return v.reshape(v.shape[0], v.shape[1], self.cfg.num_heads, -1).contiguous()

    def packed_coords(self, off: torch.Tensor, raw_attn: torch.Tensor, ref: torch.Tensor,
                      spatial_shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """Grid queries' packed coordinates (bs, nq, 3*HLP) fp32 [x | y | w]
        from the offsets (bs, nq, h, L, P, 2) and attention logits (bs, nq,
        HLP), both fp32, and the references (bs, nq, L, 2): the offsets
        multiplied by the reciprocal level sizes, as the packed JAX path
        does, and the logits softmaxed over each head's L*P taps."""
        c = self.cfg
        bs, nq = off.shape[:2]
        attn = raw_attn.reshape(bs, nq, c.num_heads, -1).softmax(-1)
        inv = level_table(spatial_shapes, "inv_wh", off.device)  # (L, 2) xy
        loc = ref[:, :, None, :, None, :] + off * inv[None, None, None, :, None, :]
        return torch.cat(
            [loc[..., 0].reshape(bs, nq, -1), loc[..., 1].reshape(bs, nq, -1), attn.reshape(bs, nq, -1)],
            dim=-1,
        )

    def forward(
        self,
        query: torch.Tensor,  # (bs, nq, C)
        value: torch.Tensor,  # (bs, nk, C)
        query_pos: Optional[torch.Tensor],
        key_padding_mask: Optional[torch.Tensor],  # (bs, nk) True = pad
        reference_points: torch.Tensor,  # (bs, nq, L, 2|4) float32
        spatial_shapes: Sequence[Tuple[int, int]],
    ) -> torch.Tensor:
        c = self.cfg
        h, L, P = c.num_heads, c.num_levels, c.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos
        bs, nq, _ = query.shape
        v = self.project_value(value, key_padding_mask)

        off = self.sampling_offsets(query).float().reshape(bs, nq, h, L, P, 2)
        raw_attn = self.attention_weights(query).float()
        ref = reference_points.float()

        if self.grid_queries and self.impl != "auto":
            if ref.shape != (bs, nq, L, 2):
                raise ValueError(f"grid queries take (bs, K, L, 2) refs, got {tuple(ref.shape)}")
            # q-minor: the query axis last in every coordinate tensor
            off_qm = off.permute(0, 2, 3, 4, 5, 1)  # (bs, h, L, P, 2, K)
            attn_qm = raw_attn.transpose(1, 2).reshape(bs, h, L * P, nq).softmax(2)
            ref_qm = ref.permute(0, 2, 3, 1)  # (bs, L, 2, K)
            norm = level_table(spatial_shapes, "hw", query.device)
            x = ref_qm[:, None, :, 0, None, :] + off_qm[..., 0, :] / norm[:, 1].view(1, 1, L, 1, 1)
            y = ref_qm[:, None, :, 1, None, :] + off_qm[..., 1, :] / norm[:, 0].view(1, 1, L, 1, 1)
            out = msda_grid_qm(v, spatial_shapes, x.contiguous(), y.contiguous(),
                               attn_qm.reshape(bs, h, L, P, nq).contiguous(),
                               impl=self.impl, radius=self.grid_radius)
            return self.output_proj(out.to(query.dtype)) + identity

        if self.grid_queries:
            if ref.shape != (bs, nq, L, 2):
                raise ValueError(f"grid queries take (bs, K, L, 2) refs, got {tuple(ref.shape)}")
            out = msda_grid_packed(v, spatial_shapes, self.packed_coords(off, raw_attn, ref, spatial_shapes), P)
        else:
            attn = raw_attn.reshape(bs, nq, h, L * P).softmax(-1).reshape(bs, nq, h, L, P)
            if ref.shape[-1] == 2:
                normalizer = level_table(spatial_shapes, "wh", query.device)
                loc = ref[:, :, None, :, None, :] + off / normalizer[None, None, None, :, None, :]
            elif ref.shape[-1] == 4:
                loc = ref[:, :, None, :, None, :2] + off / P * ref[:, :, None, :, None, 2:] * 0.5
            else:
                raise ValueError(f"reference_points last dim must be 2 or 4, got {ref.shape[-1]}")
            out = multi_scale_deformable_attention(v, spatial_shapes, loc.contiguous(), attn)
        return self.output_proj(out.to(query.dtype)) + identity
