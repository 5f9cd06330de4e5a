"""Decoder cross-attention MSDA on a shared raw-memory corner table: the
port of ``codetr_tpu/ops/msda_dectab.py`` (plain XLA there, ordinary torch
ops here).

The decoder layers all sample the same encoder memory; only their
``value_proj`` weights differ.  Bilinear interpolation is linear, so the
projection commutes with the sampling:

    out_h = W_h @ (sum_taps cw * mem[tap]) + b_h * (sum_taps cw)

So one pitched 4-corner table of the raw (unprojected) memory is built once
a forward (``build_raw_quad_table``) and shared by every layer; each layer
gathers one table row per (query, head, level, point) tap
(``msda_from_raw_table``) and applies its own ``value_proj`` to the small
interpolated result (``models/msda_module.py``).  It is off by default in
both packages (``DinoTransformerDecoder(dectab=False)``): on the TPU it
measured slower than the per-layer gather, since a tap fetches all of the
memory's channels where the gather fetches one head's projected ones.

Masking: the reference zeroes the projected values at padded keys, so a
padded key contributes neither ``W @ mem`` nor the bias.  The table holds
the memory zeroed at padded keys plus an "unmasked" indicator channel
(``raw_memory_aug``); interpolating the indicator with the same corner
weights gives the bias multiplier ``sum cw * unmasked`` for any mask, and
drops the bias at out-of-image corners as well.

Sampling is ``grid_sample``'s (bilinear, zeros padding, ``align_corners=
False``: a location maps to pixel ``loc * size - 0.5``).  The table's row
``k`` of the pitched layout (every level padded to the widest level's
width, the pitch) carries ``[m[k] | m[k+1] | m[k+pitch] | m[k+pitch+1]]``;
a tap's row start is clamped inside its level, its four corners shift
slots under the clamp, and a corner outside the image, or a slot the clamp
pushed out of the 2x2 block (the rolls' wrap rows among them), weighs 0.

``msda_from_raw_table_plain`` (the direct interpolation of the raw memory,
heads folded into the query axis) is the plain version the tests hold the
table path against.  Nothing here launches a kernel of this repository.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from codetr_torch.ops.msda import msda_plain

Shapes = Sequence[Tuple[int, int]]


def _pitch_meta(spatial_shapes: Shapes):
    """(pitch, first table row of each level and the total (L + 1,), R):
    the pitch is the widest level's width."""
    pitch = max(w for _, w in spatial_shapes)
    heights = np.asarray([hh for hh, _ in spatial_shapes], np.int64)
    row_base = np.concatenate([[0], np.cumsum(heights * pitch)])
    return pitch, row_base, int(row_base[-1])


def _level_meta_made(shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    _, row_base, _ = _pitch_meta(shapes)
    rows = [[w for _, w in shapes], [h for h, _ in shapes], row_base[:-1].tolist()]
    return torch.tensor(rows, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=64)
def _level_meta_cached(shapes: Tuple[Tuple[int, int], ...], device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return _level_meta_made(shapes, device)


def _level_meta(spatial_shapes: Shapes, device: torch.device) -> torch.Tensor:
    """(3, L) int64 [widths, heights, first table row] on ``device``.
    Cached per shapes and device, as ``models/msda_module.level_table`` is
    (a host-made tensor is a copy that a CUDA-graph capture refuses); made
    anew while ``torch.export`` traces."""
    shapes = tuple((int(hh), int(ww)) for hh, ww in spatial_shapes)
    if torch.compiler.is_compiling():
        return _level_meta_made(shapes, device)
    return _level_meta_cached(shapes, device)


def raw_memory_aug(memory: torch.Tensor, key_padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(bs, K, C) memory -> (bs, K, C + 1) in the memory's dtype: the memory
    zeroed at padded keys, then the "unmasked" indicator channel (1, or 0 at
    a padded key), as the JAX decoder builds it
    (``codetr_tpu/models/transformer.py:257-268``)."""
    if key_padding_mask is None:
        unmask = torch.ones(memory.shape[:2], dtype=memory.dtype, device=memory.device)
        mem_z = memory
    else:
        unmask = 1.0 - key_padding_mask.to(memory.dtype)
        mem_z = memory * unmask[..., None]
    return torch.cat([mem_z, unmask[..., None]], dim=-1)


def build_raw_quad_table(mem_aug: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
    """(bs, K, Cm) raw memory (+ indicator channel) -> the pitched 4-corner
    table (bs * R, 4 * Cm) in ``mem_aug``'s dtype: each level padded on the
    right to the pitch, the levels and batch entries concatenated, and the
    rows rolled by 1, pitch and pitch + 1 beside the rows themselves.  Pure
    data movement: the JAX table bit for bit."""
    bs, K, Cm = mem_aug.shape
    pitch, _, R = _pitch_meta(spatial_shapes)
    if sum(h * w for h, w in spatial_shapes) != K:
        raise ValueError(f"spatial_shapes cover {sum(h * w for h, w in spatial_shapes)} keys, memory has {K}")
    parts, t0 = [], 0
    for Hl, Wl in spatial_shapes:
        m_l = mem_aug[:, t0:t0 + Hl * Wl].reshape(bs, Hl, Wl, Cm)
        parts.append(F.pad(m_l, (0, 0, 0, pitch - Wl)).reshape(bs, Hl * pitch, Cm))
        t0 += Hl * Wl
    pitched = torch.cat(parts, dim=1).reshape(bs * R, Cm)
    return torch.cat([pitched, *(torch.roll(pitched, -s, 0) for s in (1, pitch, pitch + 1))], dim=1)


def _axis_weights(pos: torch.Tensor, size: torch.Tensor):
    """One axis of every tap: the clamped row (column) start, and the
    weights of slots 0 and 1 of the 2x2 block at that start (the corner in
    the slot, its hat and whether it lies inside the level)."""
    f = torch.floor(pos)
    frac = pos - f
    i0 = f.long()
    start = torch.minimum(i0.clamp(min=0), (size - 2).clamp(min=0))
    d0 = i0 - start  # the slot of corner 0: 0 unless the clamp moved the start
    weights = []
    for slot in (0, 1):
        c = slot - d0  # which corner (0 or 1) lands in this slot
        hat = torch.where(c == 1, frac, 1.0 - frac)
        keep = ((c == 0) | (c == 1)) & (start + slot < size)
        weights.append(torch.where(keep, hat, torch.zeros_like(hat)))
    return start, weights


def msda_from_raw_table(
    table4: torch.Tensor,  # (bs * R, 4 * Cm) from build_raw_quad_table
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,  # (bs, Q, h, L, P, 2) normalised xy
    attention_weights: torch.Tensor,  # (bs, Q, h, L, P)
) -> torch.Tensor:
    """Interpolate the raw memory at every tap and sum over levels and
    points -> (bs, Q, h, Cm) fp32 ``sum_{l,p} cw * mem_aug[tap]``, cw the
    attention weight times the bilinear corner weight, 0 for a corner
    outside the image: the pre-projection statistic of MSDA for each head.
    One table row a tap (its four corners), weighed per slot and summed by
    one batched product in fp32."""
    N4, C4 = table4.shape
    Cm = C4 // 4
    bs, Q, h, L, P, _ = sampling_locations.shape
    if attention_weights.shape != (bs, Q, h, L, P):
        raise ValueError(f"attention weights {tuple(attention_weights.shape)}, want {(bs, Q, h, L, P)}")
    pitch, _, R = _pitch_meta(spatial_shapes)
    if N4 != bs * R:
        raise ValueError(f"a table of {N4} rows for {bs} images of {R} pitched rows")
    meta = _level_meta(spatial_shapes, table4.device).view(3, 1, 1, 1, L, 1)
    widths, heights, base = meta[0], meta[1], meta[2]
    loc = sampling_locations.float()
    cs, (ax0, ax1) = _axis_weights(loc[..., 0] * widths.float() - 0.5, widths)
    rs, (ay0, ay1) = _axis_weights(loc[..., 1] * heights.float() - 0.5, heights)
    b_off = (torch.arange(bs, device=table4.device) * R).view(bs, 1, 1, 1, 1)
    starts = b_off + base + rs * pitch + cs  # (bs, Q, h, L, P)
    attw = attention_weights.float()
    # slot order of a row: (0, 0), (0, 1), (1, 0), (1, 1) as (y, x)
    w4 = torch.stack([ay0 * ax0, ay0 * ax1, ay1 * ax0, ay1 * ax1], dim=-1) * attw[..., None]
    rows = table4.index_select(0, starts.reshape(-1)).view(bs * Q * h, L * P * 4, Cm)
    out = torch.bmm(w4.reshape(bs * Q * h, 1, L * P * 4), rows.float())
    return out.view(bs, Q, h, Cm)


def msda_from_raw_table_plain(
    mem_aug: torch.Tensor,  # (bs, K, Cm)
    spatial_shapes: Shapes,
    sampling_locations: torch.Tensor,  # (bs, Q, h, L, P, 2)
    attention_weights: torch.Tensor,  # (bs, Q, h, L, P)
) -> torch.Tensor:
    """Plain version of ``build_raw_quad_table`` + ``msda_from_raw_table``:
    the direct bilinear interpolation of the raw memory (``ops/msda.py:
    msda_plain`` on one head of Cm channels), the heads folded into the
    query axis -> (bs, Q, h, Cm) fp32."""
    bs, Q, h, L, P, _ = sampling_locations.shape
    K, Cm = mem_aug.shape[1], mem_aug.shape[2]
    loc = sampling_locations.float().reshape(bs, Q * h, 1, L, P, 2)
    w = attention_weights.float().reshape(bs, Q * h, 1, L, P)
    out = msda_plain(mem_aug.float().reshape(bs, K, 1, Cm), spatial_shapes, loc[..., 0], loc[..., 1], w)
    return out.view(bs, Q, h, Cm)
