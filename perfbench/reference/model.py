"""Co-DINO (Swin-L or R50 backbone, ChannelMapper neck, CoDINO head) in
plain float32 PyTorch: the benchmark's reference forward.

It follows mmdetection's Co-DINO at inference (the configs named in
``perfbench/configs``): NHWC images in, per image the top ``max_per_img``
(boxes xyxy in canvas pixels, scores, labels) out, before any NMS.  Module
and parameter names are mmdetection's checkpoint keys, so one state dict
loads into this model and into the program under test.

Plain operations only: no custom kernel, no cache, no batching trick.
Multi-scale deformable attention is a flat gather of the four bilinear
corners (``msda``).  Every matrix product and convolution runs in float32;
the caller turns TF32 off (``reference.run.fp32_flags``).

``Precision(gemm=torch.float8_e4m3fn)`` rounds both operands of every
Linear and convolution to that type (per-tensor scale, then back to
float32): the lower-precision control that the comparison must reject.
Departures from mmdetection: none in the arithmetic; dropout and stochastic
depth are absent (inert at inference).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Shapes = Tuple[Tuple[int, int], ...]
EPS = 1e-5  # LayerNorm, GroupNorm and frozen BatchNorm


@dataclass
class Precision:
    """``gemm``: None (float32 operands) or a float8 dtype the operands of
    every Linear and convolution are rounded to."""

    gemm: Optional[torch.dtype] = None

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        if self.gemm is None:
            return t
        fmax = torch.finfo(self.gemm).max
        scale = t.abs().amax().clamp(min=1e-30) / fmax
        return (t / scale).to(self.gemm).to(torch.float32) * scale


class Linear(nn.Linear):
    def __init__(self, prec: Precision, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prec = prec

    def forward(self, x):
        return F.linear(self.prec.operand(x), self.prec.operand(self.weight), self.bias)


class Conv2d(nn.Conv2d):
    def __init__(self, prec: Precision, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.prec = prec

    def forward(self, x):
        return self._conv_forward(self.prec.operand(x), self.prec.operand(self.weight), self.bias)


def linear(prec: Precision, x, w, b):
    return F.linear(prec.operand(x), prec.operand(w), b)


def mlp(prec, in_dim: int, hidden: int, out_dim: int, num_layers: int) -> nn.Sequential:
    layers = []
    dims = [in_dim] + [hidden] * (num_layers - 1)
    for i, d in enumerate(dims):
        if i:
            layers.append(nn.ReLU())
        layers.append(Linear(prec, d, hidden if i < num_layers - 1 else out_dim))
    return nn.Sequential(*layers)


class FFN(nn.Module):
    def __init__(self, prec, dims: int, hidden: int, activation: str = "relu", add_identity: bool = True):
        super().__init__()
        act = nn.ReLU() if activation == "relu" else nn.GELU()
        self.layers = nn.Sequential(nn.Sequential(Linear(prec, dims, hidden), act), Linear(prec, hidden, dims))
        self.add_identity = add_identity

    def forward(self, x):
        out = self.layers(x)
        return x + out if self.add_identity else out


def pad_corner(x: torch.Tensor, mh: int, mw: int) -> torch.Tensor:
    """Zero-pad an NHWC map bottom/right to multiples of (mh, mw)."""
    ph, pw = (-x.shape[1]) % mh, (-x.shape[2]) % mw
    return F.pad(x, (0, 0, 0, pw, 0, ph)) if ph or pw else x


# ---------------------------------------------------------------- Swin-L


def relative_position_index(ws: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    return (rel[0] + ws - 1) * (2 * ws - 1) + (rel[1] + ws - 1)


def shift_mask(h: int, w: int, ws: int, shift: int, device) -> torch.Tensor:
    img = np.zeros((h, w), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    img = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    diff = img[:, None, :] - img[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32)).to(device)


def window_partition(x, ws):
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, C)


def window_reverse(win, ws, H, W):
    C = win.shape[-1]
    B = win.shape[0] // ((H // ws) * (W // ws))
    x = win.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


class WindowMSA(nn.Module):
    def __init__(self, prec, dims, heads, ws):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.scale = (dims // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * ws - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(ws), persistent=False)
        self.qkv = Linear(prec, dims, 3 * dims)
        self.proj = Linear(prec, dims, dims)

    def forward(self, x, mask=None):
        B, N, C = x.shape
        h = self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, h, C // h).permute(2, 0, 3, 1, 4).unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(N, N, h).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B // nW, nW, h, N, N) + mask[None, :, None]).reshape(B, h, N, N)
        out = attn.softmax(-1) @ v
        return self.proj(out.transpose(1, 2).reshape(B, N, C))


class ShiftWindowMSA(nn.Module):
    def __init__(self, prec, dims, heads, ws, shift):
        super().__init__()
        self.ws, self.shift = ws, shift
        self.w_msa = WindowMSA(prec, dims, heads, ws)

    def forward(self, x):
        B, H, W, C = x.shape
        ws, s = self.ws, self.shift
        x = pad_corner(x, ws, ws)
        Hp, Wp = x.shape[1], x.shape[2]
        mask = None
        if s:
            x = torch.roll(x, (-s, -s), (1, 2))
            mask = shift_mask(Hp, Wp, ws, s, x.device)
        x = window_reverse(self.w_msa(window_partition(x, ws), mask), ws, Hp, Wp)
        if s:
            x = torch.roll(x, (s, s), (1, 2))
        return x[:, :H, :W]


class SwinBlock(nn.Module):
    def __init__(self, prec, dims, heads, hidden, ws, shift):
        super().__init__()
        self.norm1 = nn.LayerNorm(dims, eps=EPS)
        self.attn = ShiftWindowMSA(prec, dims, heads, ws, ws // 2 if shift else 0)
        self.norm2 = nn.LayerNorm(dims, eps=EPS)
        self.ffn = FFN(prec, dims, hidden, "gelu", add_identity=False)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.ffn(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, prec, c_in, dims, patch):
        super().__init__()
        self.patch = patch
        self.projection = Conv2d(prec, c_in, dims, patch, patch)
        self.norm = nn.LayerNorm(dims, eps=EPS)

    def forward(self, x):
        x = pad_corner(x, self.patch, self.patch)
        return self.norm(self.projection(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))


class PatchMerging(nn.Module):
    """2x2 neighbourhood in ``nn.Unfold``'s channel-major order -> LN -> Linear."""

    def __init__(self, prec, c_in, c_out):
        super().__init__()
        self.norm = nn.LayerNorm(4 * c_in, eps=EPS)
        self.reduction = Linear(prec, 4 * c_in, c_out, bias=False)

    def forward(self, x):
        x = pad_corner(x, 2, 2)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 5, 2, 4).reshape(B, H // 2, W // 2, 4 * C)
        return self.reduction(self.norm(x))


class Stage(nn.Module):
    def __init__(self, prec, dims, heads, depth, cfg, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(prec, dims, heads, cfg["mlp_ratio"] * dims, cfg["window_size"], i % 2 == 1)
            for i in range(depth))
        self.downsample = PatchMerging(prec, dims, 2 * dims) if downsample else None


class Swin(nn.Module):
    def __init__(self, prec, cfg):
        super().__init__()
        self.out_indices = tuple(cfg["out_indices"])
        e = cfg["embed_dims"]
        widths = [e * 2**i for i in range(len(cfg["depths"]))]
        self.patch_embed = PatchEmbed(prec, 3, e, cfg["patch_size"])
        n = len(cfg["depths"])
        self.stages = nn.ModuleList(
            Stage(prec, widths[i], cfg["num_heads"][i], d, cfg, i < n - 1) for i, d in enumerate(cfg["depths"]))
        for i in self.out_indices:
            self.add_module(f"norm{i}", nn.LayerNorm(widths[i], eps=EPS))

    def forward(self, x) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage.blocks:
                x = block(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x).permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return outs


# ---------------------------------------------------------------- ResNet-50


class FrozenBN(nn.Module):
    def __init__(self, n):
        super().__init__()
        for name, v in (("weight", 1.0), ("bias", 0.0), ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((n,), v))

    def forward(self, x):
        inv = torch.rsqrt(self.running_var + EPS) * self.weight
        return x * inv[:, None, None] + (self.bias - self.running_mean * inv)[:, None, None]


class Bottleneck(nn.Module):
    def __init__(self, prec, c_in, mid, stride, downsample):
        super().__init__()
        self.conv1, self.bn1 = Conv2d(prec, c_in, mid, 1, bias=False), FrozenBN(mid)
        self.conv2, self.bn2 = Conv2d(prec, mid, mid, 3, stride, padding=1, bias=False), FrozenBN(mid)
        self.conv3, self.bn3 = Conv2d(prec, mid, 4 * mid, 1, bias=False), FrozenBN(4 * mid)
        self.downsample = (nn.Sequential(Conv2d(prec, c_in, 4 * mid, 1, stride, bias=False), FrozenBN(4 * mid))
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu((x if self.downsample is None else self.downsample(x)) + y)


class ResNet(nn.Module):
    BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}

    def __init__(self, prec, cfg):
        super().__init__()
        self.out_indices = tuple(cfg["out_indices"])
        self.num_stages = cfg["num_stages"]
        stem, base = cfg["stem_channels"], cfg["base_channels"]
        self.conv1 = Conv2d(prec, 3, stem, 7, 2, padding=3, bias=False)
        self.bn1 = FrozenBN(stem)
        c_in = stem
        for s, n in enumerate(self.BLOCKS[cfg["depth"]][:self.num_stages]):
            mid = base * 2**s
            blocks = []
            for b in range(n):
                blocks.append(Bottleneck(prec, c_in, mid, 2 if b == 0 and s > 0 else 1, b == 0))
                c_in = 4 * mid
            self.add_module(f"layer{s + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)))), 3, 2, padding=1)
        outs = []
        for s in range(self.num_stages):
            x = getattr(self, f"layer{s + 1}")(x)
            if s in self.out_indices:
                outs.append(x)
        return outs


# ---------------------------------------------------------------- neck


class ConvGN(nn.Module):
    def __init__(self, prec, c_in, c_out, k, stride, groups):
        super().__init__()
        self.conv = Conv2d(prec, c_in, c_out, k, stride, padding=k // 2)
        self.gn = nn.GroupNorm(groups, c_out, eps=EPS)

    def forward(self, x):
        gn = self.gn
        return torch.group_norm(self.conv(x), gn.num_groups, gn.weight, gn.bias, gn.eps)


class ChannelMapper(nn.Module):
    def __init__(self, prec, cfg):
        super().__init__()
        c_out, g = cfg["out_channels"], cfg["num_groups"]
        ins = cfg["in_channels"]
        self.convs = nn.ModuleList(ConvGN(prec, c, c_out, cfg["kernel_size"], 1, g) for c in ins)
        self.extra_convs = nn.ModuleList(
            ConvGN(prec, ins[-1] if j == 0 else c_out, c_out, 3, 2, g) for j in range(cfg["num_outs"] - len(ins)))

    def forward(self, feats):
        outs = [m(x) for m, x in zip(self.convs, feats)]
        for j, m in enumerate(self.extra_convs):
            outs.append(m(feats[-1] if j == 0 else outs[-1]))
        return outs


# ---------------------------------------------------------------- MSDA


def msda(value, shapes: Shapes, x, y, w, q_chunk: int = 8192):
    """Deformable attention as a flat gather of the 4 bilinear corners
    (``grid_sample``, bilinear, zeros padding, align_corners=False).
    value (bs, K, h, d); x, y, w (bs, Q, h, L, P) -> (bs, Q, h*d)."""
    bs, K, h, d = value.shape
    Q, L = x.shape[1], x.shape[3]
    dev = value.device
    table = value.reshape(bs * K * h, d)
    s5 = (1, 1, 1, L, 1)
    widths = torch.tensor([ww for _, ww in shapes], device=dev).view(s5)
    heights = torch.tensor([hh for hh, _ in shapes], device=dev).view(s5)
    starts = np.cumsum([0] + [hh * ww for hh, ww in shapes[:-1]]).tolist()
    start = torch.tensor(starts, device=dev).view(s5)
    b_off = (torch.arange(bs, device=dev) * K).view(bs, 1, 1, 1, 1)
    head = torch.arange(h, device=dev).view(1, 1, h, 1, 1)
    out = []
    for q0 in range(0, Q, q_chunk):
        q1 = min(Q, q0 + q_chunk)
        px = x[:, q0:q1] * widths - 0.5
        py = y[:, q0:q1] * heights - 0.5
        fx, fy = torch.floor(px), torch.floor(py)
        tx, ty = px - fx, py - fy
        x0, y0 = fx.long(), fy.long()
        acc = 0.0
        for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
            xi, yi = x0 + cx, y0 + cy
            ok = (xi >= 0) & (xi < widths) & (yi >= 0) & (yi < heights)
            k = start + yi.clamp(min=0).minimum(heights - 1) * widths + xi.clamp(min=0).minimum(widths - 1)
            rows = table[((b_off + k) * h + head).reshape(-1)].view(*k.shape, d)
            cw = (tx if cx else 1 - tx) * (ty if cy else 1 - ty) * ok * w[:, q0:q1]
            acc = acc + rows * cw[..., None]
        out.append(acc.sum(dim=(3, 4)))
    return torch.cat(out, 1).reshape(bs, Q, h * d)


def grid_offset_bias(heads: int, levels: int, points: int) -> torch.Tensor:
    """mmdetection's sampling-offset bias init, interleaved (h, L, P, 2)."""
    th = torch.arange(heads, dtype=torch.float64) * (2.0 * math.pi / heads)
    g = torch.stack([th.cos(), th.sin()], -1)
    g = g / g.abs().max(-1, keepdim=True)[0]
    g = g[:, None, None, :].repeat(1, levels, points, 1)
    g = g * torch.arange(1, points + 1, dtype=torch.float64)[None, None, :, None]
    return g.reshape(-1).float()


class MSDA(nn.Module):
    def __init__(self, prec, E, cfg):
        super().__init__()
        self.h, self.L, self.P = cfg["num_heads"], cfg["num_levels"], cfg["num_points"]
        n = self.h * self.L * self.P
        inner = int(E * cfg["value_proj_ratio"])
        self.sampling_offsets = Linear(prec, E, 2 * n)
        self.attention_weights = Linear(prec, E, n)
        self.value_proj = Linear(prec, E, inner)
        self.output_proj = Linear(prec, inner, E)

    def forward(self, query, value, query_pos, pad_mask, ref, shapes: Shapes):
        h, L, P = self.h, self.L, self.P
        identity = query
        query = query + query_pos
        bs, nq, _ = query.shape
        v = self.value_proj(value).masked_fill(pad_mask[..., None], 0.0)
        v = v.reshape(bs, v.shape[1], h, -1)
        off = self.sampling_offsets(query).reshape(bs, nq, h, L, P, 2)
        attn = self.attention_weights(query).reshape(bs, nq, h, L * P).softmax(-1).reshape(bs, nq, h, L, P)
        if ref.shape[-1] == 2:
            wh = torch.tensor([[ww, hh] for hh, ww in shapes], dtype=torch.float32, device=query.device)
            loc = ref[:, :, None, :, None, :] + off / wh[None, None, None, :, None, :]
        else:
            loc = ref[:, :, None, :, None, :2] + off / P * ref[:, :, None, :, None, 2:] * 0.5
        out = msda(v, shapes, loc[..., 0], loc[..., 1], attn)
        return self.output_proj(out) + identity


class SelfAttention(nn.Module):
    """Decoder self-attention with torch's packed names (``attn.in_proj_weight``)."""

    def __init__(self, prec, E, heads):
        super().__init__()
        self.prec, self.E, self.heads = prec, E, heads
        self.attn = nn.Module()
        self.attn.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
        self.attn.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        self.attn.out_proj = Linear(prec, E, E)

    def forward(self, query, query_pos):
        E, nh = self.E, self.heads
        d = E // nh
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        qk = query + query_pos
        q, k = linear(self.prec, qk, w[:E], b[:E]), linear(self.prec, qk, w[E:2 * E], b[E:2 * E])
        v = linear(self.prec, query, w[2 * E:], b[2 * E:])
        bs, nq, _ = q.shape
        q, k, v = (t.reshape(bs, nq, nh, d).transpose(1, 2) for t in (q, k, v))
        out = ((q @ k.transpose(-2, -1)) * (1.0 / d**0.5)).softmax(-1) @ v
        return query + self.attn.out_proj(out.transpose(1, 2).reshape(bs, nq, E))


# ---------------------------------------------------------------- transformer and head


def sine_pos(mask, cfg):
    """(bs, H, W) mask, nonzero = pad -> (bs, H, W, 2*num_feats)."""
    not_mask = 1.0 - mask.float()
    y, x = not_mask.cumsum(1), not_mask.cumsum(2)
    if cfg["normalize"]:
        y = (y + cfg["offset"]) / (y[:, -1:, :] + cfg["eps"]) * cfg["scale"]
        x = (x + cfg["offset"]) / (x[:, :, -1:] + cfg["eps"]) * cfg["scale"]
    n = cfg["num_feats"]
    dim_t = cfg["temperature"] ** (2.0 * torch.floor(torch.arange(n, device=mask.device, dtype=torch.float32) / 2) / n)

    def sc(p):
        return torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()), -1).flatten(-2)

    return torch.cat((sc(y[..., None] / dim_t), sc(x[..., None] / dim_t)), 3)


def sine_embed(pos, feats: int):
    """(bs, nq, 4) boxes -> (bs, nq, 4*feats), ordered y, x, w, h."""
    dim_t = 10000.0 ** (2.0 * torch.floor(torch.arange(feats, device=pos.device, dtype=torch.float32) / 2) / feats)

    def emb(c):
        p = c[..., None] * (2.0 * math.pi) / dim_t
        return torch.stack((p[..., 0::2].sin(), p[..., 1::2].cos()), -1).flatten(-2)

    return torch.cat([emb(pos[..., i]) for i in (1, 0, 2, 3)], 2)


def nearest_mask(mask, oh, ow):
    H, W = mask.shape[1:]
    dev = mask.device
    rows = torch.floor(torch.arange(oh, device=dev, dtype=torch.float32) * (H / oh)).long()
    cols = torch.floor(torch.arange(ow, device=dev, dtype=torch.float32) * (W / ow)).long()
    return mask[:, rows][:, :, cols]


class EncoderLayer(nn.Module):
    def __init__(self, prec, cfg):
        super().__init__()
        E = cfg["embed_dims"]
        self.attentions = nn.ModuleList([MSDA(prec, E, cfg["msda"])])
        self.norms = nn.ModuleList(nn.LayerNorm(E, eps=EPS) for _ in range(2))
        self.ffns = nn.ModuleList([FFN(prec, E, cfg["encoder_ffn"])])

    def forward(self, q, pos, pad, ref, shapes):
        q = self.norms[0](self.attentions[0](q, q, pos, pad, ref, shapes))
        return self.norms[1](self.ffns[0](q))


class DecoderLayer(nn.Module):
    def __init__(self, prec, cfg):
        super().__init__()
        E = cfg["embed_dims"]
        self.attentions = nn.ModuleList([SelfAttention(prec, E, cfg["decoder_self_attn_heads"]),
                                         MSDA(prec, E, cfg["msda"])])
        self.norms = nn.ModuleList(nn.LayerNorm(E, eps=EPS) for _ in range(3))
        self.ffns = nn.ModuleList([FFN(prec, E, cfg["decoder_ffn"])])

    def forward(self, q, pos, memory, pad, ref, shapes):
        q = self.norms[0](self.attentions[0](q, pos))
        q = self.norms[1](self.attentions[1](q, memory, pos, pad, ref, shapes))
        return self.norms[2](self.ffns[0](q))


class Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class Decoder(nn.Module):
    def __init__(self, prec, cfg):
        super().__init__()
        E = cfg["embed_dims"]
        self.layers = nn.ModuleList(DecoderLayer(prec, cfg) for _ in range(cfg["num_decoder_layers"]))
        self.ref_point_head = mlp(prec, 2 * E, E, E, 2)
        self.norm = nn.LayerNorm(E, eps=EPS)


class Transformer(nn.Module):
    def __init__(self, prec, cfg):
        super().__init__()
        E = cfg["embed_dims"]
        self.cfg = cfg
        self.level_embeds = nn.Parameter(torch.empty(cfg["num_feature_levels"], E))
        self.encoder = Layers(EncoderLayer(prec, cfg) for _ in range(cfg["num_encoder_layers"]))
        self.decoder = Decoder(prec, cfg)
        self.enc_output = Linear(prec, E, E)
        self.enc_output_norm = nn.LayerNorm(E, eps=EPS)
        self.query_embed = nn.Embedding(cfg["two_stage_num_proposals"], E)


class CoDINO(nn.Module):
    """The whole model.  ``forward(images (bs, H, W, 3) normalised, masks
    (bs, H, W) 1 = pad) -> (boxes (bs, N, 4) xyxy canvas px, scores,
    labels)``, the top ``max_per_img``; ``queries(images, masks)`` -> every
    query's (boxes (bs, Q, 4), class scores (bs, Q, num_classes))."""

    def __init__(self, cfg: dict, prec: Optional[Precision] = None):
        super().__init__()
        self.cfg = cfg
        self.prec = prec = prec or Precision()
        bb = cfg["backbone"]
        self.backbone = Swin(prec, bb) if bb["type"] == "swin" else ResNet(prec, bb)
        self.neck = ChannelMapper(prec, cfg["neck"])
        tf, head = cfg["transformer"], cfg["head"]
        E, n_pred = tf["embed_dims"], tf["num_decoder_layers"] + 1
        self.query_head = nn.Module()
        self.query_head.cls_branches = nn.ModuleList(Linear(prec, E, head["num_classes"]) for _ in range(n_pred))
        self.query_head.reg_branches = nn.ModuleList(
            mlp(prec, E, E, 4, head["num_reg_fcs"] + 1) for _ in range(n_pred))
        self.query_head.transformer = Transformer(prec, tf)

    def forward(self, images, masks):
        return top_detections(*self.queries(images, masks), self.cfg["head"]["max_per_img"])

    def queries(self, images, masks):
        return self.head(self.neck(self.backbone(images)), masks)

    def head(self, feats, img_masks):
        tf_cfg, head = self.cfg["transformer"], self.cfg["head"]
        qh = self.query_head
        tf = qh.transformer
        cls_b, reg_b = qh.cls_branches, qh.reg_branches
        nd = tf_cfg["num_decoder_layers"]
        bs = feats[0].shape[0]

        masks = [nearest_mask(img_masks, f.shape[2], f.shape[3]) != 0 for f in feats]
        pos = [sine_pos(m, head["positional_encoding"]) for m in masks]
        shapes: Shapes = tuple((f.shape[2], f.shape[3]) for f in feats)
        src = torch.cat([f.flatten(2).transpose(1, 2) for f in feats], 1)
        pad = torch.cat([m.flatten(1) for m in masks], 1)
        pos_flat = torch.cat([p.flatten(1, 2) + tf.level_embeds[i] for i, p in enumerate(pos)], 1)
        valid = torch.stack([torch.stack([(1.0 - m[:, 0, :].float()).sum(1) / m.shape[2],
                                          (1.0 - m[:, :, 0].float()).sum(1) / m.shape[1]], -1)
                             for m in masks], 1)  # (bs, L, 2) [w, h] ratios
        refs = []
        for lvl, (H, W) in enumerate(shapes):
            ry, rx = torch.meshgrid(torch.linspace(0.5, H - 0.5, H, device=src.device),
                                    torch.linspace(0.5, W - 0.5, W, device=src.device), indexing="ij")
            refs.append(torch.stack((rx.reshape(1, -1) / (valid[:, lvl, 0:1] * W),
                                     ry.reshape(1, -1) / (valid[:, lvl, 1:2] * H)), -1))
        ref = torch.cat(refs, 1)  # (bs, K, 2)

        memory = src
        ref_lvl = ref[:, :, None] * valid[:, None]
        for layer in tf.encoder.layers:
            memory = layer(memory, pos_flat, pad, ref_lvl, shapes)

        # two-stage proposals
        width = torch.cat([torch.full((H * W,), 0.05 * 2.0**lvl, device=src.device)
                           for lvl, (H, W) in enumerate(shapes)])
        props = torch.cat([ref, width[None, :, None].expand(bs, -1, 2)], -1)
        props = torch.log(props / (1 - props))
        ok = ((props > -4.6) & (props < 4.6)).all(-1, keepdim=True) & ~pad[..., None]
        props = torch.where(ok, props, torch.full_like(props, torch.finfo(torch.float32).max))
        out_mem = tf.enc_output_norm(tf.enc_output(torch.where(ok, memory, torch.zeros_like(memory))))
        enc_class = cls_b[nd](out_mem)
        enc_coord = reg_b[nd](out_mem) + props
        nq = tf_cfg["two_stage_num_proposals"]
        topk = torch.topk(enc_class.max(-1)[0], nq, dim=1)[1]
        refs_unact = torch.gather(enc_coord, 1, topk[..., None].expand(-1, -1, 4))

        # decoder with iterative box refinement
        E = tf_cfg["embed_dims"]
        query = tf.query_embed.weight[None].expand(bs, -1, -1)
        vr4 = torch.cat([valid, valid], -1)
        dec = tf.decoder
        states = []
        for lid, layer in enumerate(dec.layers):
            ref_in = refs_unact.sigmoid()[:, :, None, :] * vr4[:, None]
            qpos = dec.ref_point_head(sine_embed(ref_in[:, :, 0, :], E // 2))
            query = layer(query, qpos, memory, pad, ref_in, shapes)
            refs_unact = reg_b[lid](query) + refs_unact
            states.append(query)
        final = dec.norm(states[-1])

        # every query's box (xyxy, canvas px) and class scores
        lvl = nd - 1
        scores = cls_b[lvl](final).sigmoid()
        cx, cy, w, h = (reg_b[lvl](final) + refs_unact).sigmoid().unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        H, W = img_masks.shape[-2:]
        scale = torch.tensor([W, H, W, H], dtype=torch.float32, device=boxes.device)
        return torch.minimum(torch.clamp(boxes * scale, min=0.0), scale), scores


def top_detections(boxes: torch.Tensor, scores: torch.Tensor, k: int):
    """Every query's (boxes (bs, Q, 4), scores (bs, Q, C)) -> the top ``k``
    (query, class) pairs: (boxes (bs, k, 4), scores (bs, k), labels (bs, k))."""
    bs, _, ncls = scores.shape
    top, idx = torch.topk(scores.reshape(bs, -1), k, dim=1)
    return torch.gather(boxes, 1, (idx // ncls)[..., None].expand(-1, -1, 4)), top, idx % ncls
