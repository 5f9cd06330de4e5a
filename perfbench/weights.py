"""The model's weights as one float32 state dict, made from the seed on the
device in a few large draws.

Names and shapes come from the reference model built on the ``meta``
device (mmdetection's checkpoint keys, which the program's model uses
too).  The rules are those of a seeded random init, by the module that
owns the tensor:

- Linear and convolution weights N(0, 1/fan_in), their biases U(-0.05, 0.05);
  the decoder self-attention's packed projection likewise;
- LayerNorm and GroupNorm at identity, the frozen BatchNorm at identity;
- Swin's relative-position bias tables N(0, 0.02^2); the level embeddings
  N(0, 1);
- deformable attention: mmdetection's sampling-offset bias, offset weights
  x 0.02 and attention-weight weights x 0.1 of the rule above;
- the head as mmdetection initialises it (``DeformableDETRHead.
  init_weights``): the classifiers' biases at the prior ``CLS_PRIOR_PROB``
  (bias = -log((1 - p) / p)); the last Linear of every box branch scaled
  by ``REG_LAST_SCALE`` (mmdetection: 0, so refinement would not run) and
  its bias 0;
- the encoder's output projection (``enc_output``) with its bias at 0: the
  padded keys, whose memory is zeroed, then score the classifiers' prior
  exactly, below every valid key's best class (with a random bias their
  one shared logit vector can outrank the valid keys and fill the 900
  proposals with one repeated query);
- the decoder's content queries (``query_embed``): one N(0, 1) row shared
  by every query, so the decoder does not depend on the proposals' order.

Why: PERF.md, "How correct is decided" (a random model that is chaotic
cannot be checked); each configuration's ``assumed`` says so too.

Every normal draw comes from one ``torch.randn`` and every uniform one from
one ``torch.rand``, both on one ``torch.Generator`` of the device.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from perfbench.reference.model import MSDA, CoDINO, FrozenBN, SelfAttention, WindowMSA, grid_offset_bias

SEED_MASK = (1 << 63) - 1
CLS_PRIOR_PROB = 0.01
REG_LAST_SCALE = 0.1


def _rule(model: nn.Module, name: str, shape):
    """-> (kind, scale, fixed): kind "normal", "normal_shared", "uniform"
    or "fixed"."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    parent = model.get_submodule(owner_name.rpartition(".")[0]) if "." in owner_name else model
    path = owner_name.split(".")
    if path[-2:-1] == ["cls_branches"] and leaf == "bias":
        return "fixed", None, torch.full(shape, -math.log((1 - CLS_PRIOR_PROB) / CLS_PRIOR_PROB))
    if path[-1] == "enc_output" and leaf == "bias":
        return "fixed", None, torch.zeros(shape)
    if path[-3:-2] == ["reg_branches"] and owner is parent[len(parent) - 1]:
        if leaf == "bias":
            return "fixed", None, torch.zeros(shape)
        return "normal", REG_LAST_SCALE * int(torch.Size(shape)[1:].numel()) ** -0.5, None
    if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
        return "fixed", None, torch.ones(shape) if leaf == "weight" else torch.zeros(shape)
    if isinstance(owner, FrozenBN):
        return "fixed", None, torch.ones(shape) if leaf in ("weight", "running_var") else torch.zeros(shape)
    if isinstance(owner, WindowMSA):  # relative_position_bias_table
        return "normal", 0.02, None
    if leaf == "level_embeds":
        return "normal", 1.0, None
    if isinstance(owner, nn.Embedding):
        return "normal_shared", 1.0, None
    if isinstance(parent, SelfAttention) or isinstance(owner, (nn.Linear, nn.Conv2d)):
        if leaf.endswith("bias"):
            if isinstance(parent, MSDA) and owner is parent.sampling_offsets:
                return "fixed", None, grid_offset_bias(parent.h, parent.L, parent.P)
            return "uniform", 0.05, None
        fan_in = int(torch.Size(shape)[1:].numel())
        scale = fan_in ** -0.5
        if isinstance(parent, MSDA):
            scale *= {"sampling_offsets": 0.02, "attention_weights": 0.1}.get(owner_name.rpartition(".")[2], 1.0)
        return "normal", scale, None
    raise ValueError(f"no init rule for {name} ({type(owner).__name__})")


@torch.no_grad()
def make_state_dict(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The float32 state dict of ``cfg``'s model for ``seed``, on ``device``."""
    with torch.device("meta"):
        model = CoDINO(cfg)
    specs = [(n, t.shape, *_rule(model, n, t.shape)) for n, t in model.state_dict().items()]

    def count(s):
        return s[1][-1] if s[2] == "normal_shared" else s[1].numel()

    n_normal = sum(count(s) for s in specs if s[2].startswith("normal"))
    n_uniform = sum(s[1].numel() for s in specs if s[2] == "uniform")
    g = torch.Generator(device=device).manual_seed(int(seed) & SEED_MASK)
    normal = torch.randn(n_normal, generator=g, device=device)
    uniform = torch.rand(n_uniform, generator=g, device=device)
    out, i, j = {}, 0, 0
    for name, shape, kind, scale, fixed in specs:
        if kind == "fixed":
            out[name] = fixed.to(device=device, dtype=torch.float32)
        elif kind == "uniform":
            n = shape.numel()
            out[name] = uniform[j:j + n].mul_(2 * scale).sub_(scale).view(shape)
            j += n
        else:
            n = count((name, shape, kind))
            t = normal[i:i + n].mul_(scale)
            out[name] = t.expand(shape).contiguous() if kind == "normal_shared" else t.view(shape)
            i += n
    return out
