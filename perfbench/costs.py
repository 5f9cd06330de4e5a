"""Operations and bytes the benchmark divides by, counted from shapes on
its own reference (never on the program), and the published peaks.

- ``forward_flops(cfg, canvas)``: FLOPs of one image's forward, the
  reference run on the ``meta`` device under ``FlopCounterMode`` (matrix
  products and convolutions) plus the deformable attention's gathers by
  ``msda_flops`` (4 corners x head dim x (multiply + add) per tap), which
  no aten matmul counts.  The count does not depend on what implements
  the forward.
- ``level_shapes(cfg, canvas)``: the neck's (h, w) per level.
- ``k1_cost(cfg, canvas, batch)``: one call of the encoder's deformable
  attention over all levels (the port's K1): FLOPs by ``msda_flops``;
  bytes = value (batch, K, C) in the compute dtype read once + packed
  coordinates (batch, K, 3 * heads * levels * points) float32 read once +
  the output (batch, K, C) in the compute dtype written once.
- ``peaks(kind)``: ``peaks.json``'s entry for a card, or None.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Tuple

import torch

from perfbench.reference.model import CoDINO

HERE = os.path.dirname(os.path.abspath(__file__))
ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2}


def msda_flops(batch: int, queries: int, heads: int, taps: int, head_dim: int) -> int:
    return batch * queries * heads * taps * 4 * head_dim * 2


def _meta_forward(cfg: dict, canvas) -> Tuple[int, Tuple[Tuple[int, int], ...]]:
    from torch.utils.flop_counter import FlopCounterMode

    h, w = canvas
    with torch.device("meta"):
        model = CoDINO(cfg)
        images = torch.zeros(1, h, w, 3)
        masks = torch.zeros(1, h, w)
    shapes = []
    hook = model.neck.register_forward_hook(lambda m, i, out: shapes.extend(tuple(o.shape[2:]) for o in out))
    counter = FlopCounterMode(display=False)
    with counter:
        model(images, masks)
    hook.remove()
    return int(counter.get_total_flops()), tuple(shapes)


@functools.lru_cache(maxsize=8)
def _forward(cfg_json: str, canvas: Tuple[int, int]):
    return _meta_forward(json.loads(cfg_json), canvas)


def level_shapes(cfg: dict, canvas) -> Tuple[Tuple[int, int], ...]:
    return _forward(json.dumps(cfg, sort_keys=True), tuple(canvas))[1]


def forward_flops(cfg: dict, canvas) -> int:
    """FLOPs of one image at ``canvas`` (height, width)."""
    gemm, shapes = _forward(json.dumps(cfg, sort_keys=True), tuple(canvas))
    tf = cfg["transformer"]
    m = tf["msda"]
    K = sum(hh * ww for hh, ww in shapes)
    head_dim = int(tf["embed_dims"] * m["value_proj_ratio"]) // m["num_heads"]
    taps = m["num_levels"] * m["num_points"]
    enc = tf["num_encoder_layers"] * msda_flops(1, K, m["num_heads"], taps, head_dim)
    dec = tf["num_decoder_layers"] * msda_flops(1, tf["two_stage_num_proposals"], m["num_heads"], taps, head_dim)
    return gemm + enc + dec


def k1_cost(cfg: dict, canvas, batch: int) -> Tuple[int, int]:
    """(FLOPs, bytes) of one encoder deformable-attention call."""
    tf = cfg["transformer"]
    m = tf["msda"]
    K = sum(hh * ww for hh, ww in level_shapes(cfg, canvas))
    C = int(tf["embed_dims"] * m["value_proj_ratio"])
    hlp = m["num_heads"] * m["num_levels"] * m["num_points"]
    item = ITEMSIZE[cfg["dtype"]]
    flops = msda_flops(batch, K, m["num_heads"], m["num_levels"] * m["num_points"], C // m["num_heads"])
    nbytes = batch * K * C * item + batch * K * 3 * hlp * 4 + batch * K * C * item
    return flops, nbytes


def peaks(kind: str) -> Optional[dict]:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)["cards"].get(kind)
