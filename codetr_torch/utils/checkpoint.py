"""JAX-package params -> this port's (mmdet-schema) state dict.

``state_dict_from_jax(params, cfg)`` takes the JAX package's flax params
tree (nested dicts of arrays, with or without the top ``"params"`` level)
and returns ``{mmdet key: numpy array}`` for ``CoDETR.load_state_dict``.
It is the inverse of the JAX package's ``convert_state_dict``:

- Dense kernels (in, out) -> Linear weights (out, in); conv HWIO -> OIHW;
  norm ``scale`` -> ``weight``;
- leaves stacked on a leading axis (the scanned Swin block pairs, encoder
  and decoder layers, and the decoder's cls/reg branch banks) are unstacked
  into per-index keys; branch 6 (the encoder stage) is separate already;
- the MSDA sampling-offset columns go from the JAX layout [x(HLP) | y(HLP)]
  back to mmdet's interleaved (h, L, P, 2);
- the decoder MHA's separate q/k/v projections are packed into
  ``in_proj_weight`` / ``in_proj_bias``;
- PatchMerging's LN and reduction rows go from the JAX concat order
  (position-major, pos * C + c) back to ``nn.Unfold``'s (c * 4 + pos).

Only numpy is used, so the port does not depend on the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from codetr_torch.config import CoDETRConfig


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _lin(k) -> np.ndarray:  # Dense kernel (in, out) -> Linear weight (out, in)
    return np.ascontiguousarray(_np(k).T)


def _conv(k) -> np.ndarray:  # HWIO -> OIHW
    return np.ascontiguousarray(np.transpose(_np(k), (3, 2, 0, 1)))


def _position_major_to_unfold(w: np.ndarray, c_in: int, axis: int = 0) -> np.ndarray:
    """Rows indexed pos * C + c along ``axis`` -> c * 4 + pos."""
    w = np.moveaxis(_np(w), axis, 0)
    rest = w.shape[1:]
    w = np.swapaxes(w.reshape(4, c_in, *rest), 0, 1).reshape(4 * c_in, *rest)
    return np.ascontiguousarray(np.moveaxis(w, 0, axis))


def _interleave_xy(a: np.ndarray, axis: int) -> np.ndarray:
    """[x(n) | y(n)] along ``axis`` -> (n, 2) interleaved."""
    a = np.moveaxis(_np(a), axis, -1)
    n = a.shape[-1] // 2
    out = np.stack([a[..., :n], a[..., n:]], axis=-1).reshape(*a.shape[:-1], 2 * n)
    return np.ascontiguousarray(np.moveaxis(out, -1, axis))


class _Out:
    def __init__(self):
        self.sd: Dict[str, np.ndarray] = {}

    def dense(self, key: str, p, bias: bool = True):
        self.sd[f"{key}.weight"] = _lin(p["kernel"])
        if bias:
            self.sd[f"{key}.bias"] = _np(p["bias"])

    def norm(self, key: str, p):
        self.sd[f"{key}.weight"] = _np(p["scale"])
        self.sd[f"{key}.bias"] = _np(p["bias"])

    def ffn(self, key: str, p):
        self.dense(f"{key}.layers.0.0", p["fc1"])
        self.dense(f"{key}.layers.1", p["fc2"])

    def msda(self, key: str, p):
        for name in ("attention_weights", "value_proj", "output_proj"):
            self.dense(f"{key}.{name}", p[name])
        so = p["sampling_offsets"]
        self.sd[f"{key}.sampling_offsets.weight"] = _lin(_interleave_xy(so["kernel"], axis=1))
        self.sd[f"{key}.sampling_offsets.bias"] = _interleave_xy(so["bias"], axis=0)


def _index(tree, i):
    """Slice every leaf of a stacked subtree at index ``i``."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return _np(tree)[i]


def _swin(out: _Out, p, cfg: CoDETRConfig):
    sc = cfg.swin
    bb = p["backbone"]
    out.sd["backbone.patch_embed.projection.weight"] = _conv(bb["patch_embed"]["projection"]["kernel"])
    out.sd["backbone.patch_embed.projection.bias"] = _np(bb["patch_embed"]["projection"]["bias"])
    out.norm("backbone.patch_embed.norm", bb["patch_embed"]["norm"])
    dims = sc.embed_dims
    for i, depth in enumerate(sc.depths):
        stacked = bb[f"stages_{i}_blocks"]
        for j in range(depth // 2):
            pair = _index(stacked, j)
            for b, name in ((2 * j, "block0"), (2 * j + 1, "block1")):
                blk, key = pair[name], f"backbone.stages.{i}.blocks.{b}"
                out.norm(f"{key}.norm1", blk["norm1"])
                out.norm(f"{key}.norm2", blk["norm2"])
                w = blk["attn"]["w_msa"]
                out.sd[f"{key}.attn.w_msa.relative_position_bias_table"] = _np(
                    w["relative_position_bias_table"]
                )
                out.dense(f"{key}.attn.w_msa.qkv", w["qkv"], bias="bias" in w["qkv"])
                out.dense(f"{key}.attn.w_msa.proj", w["proj"])
                out.ffn(f"{key}.ffn", blk["ffn"])
        if i < len(sc.depths) - 1:
            ds, key = bb[f"stages_{i}_downsample"], f"backbone.stages.{i}.downsample"
            out.sd[f"{key}.norm.weight"] = _position_major_to_unfold(ds["norm"]["scale"], dims)
            out.sd[f"{key}.norm.bias"] = _position_major_to_unfold(ds["norm"]["bias"], dims)
            out.sd[f"{key}.reduction.weight"] = _position_major_to_unfold(
                _lin(ds["reduction"]["kernel"]), dims, axis=1
            )
            dims *= 2
    for i in sc.out_indices:
        out.norm(f"backbone.norm{i}", bb[f"norm{i}"])


def _neck(out: _Out, p, cfg: CoDETRConfig):
    neck = p["neck"]
    blocks = [(f"convs_{i}", f"convs.{i}") for i in range(len(cfg.neck.in_channels))]
    blocks += [
        (f"extra_convs_{j}", f"extra_convs.{j}")
        for j in range(cfg.neck.num_outs - len(cfg.neck.in_channels))
    ]
    for src, dst in blocks:
        out.sd[f"neck.{dst}.conv.weight"] = _conv(neck[f"{src}_conv"]["kernel"])
        out.sd[f"neck.{dst}.conv.bias"] = _np(neck[f"{src}_conv"]["bias"])
        out.norm(f"neck.{dst}.gn", neck[f"{src}_gn"])


def _head(out: _Out, p, cfg: CoDETRConfig):
    tc = cfg.head.transformer
    nd = tc.num_decoder_layers
    qh = p["query_head"]
    n_lin = cfg.head.num_reg_fcs + 1
    for i in range(nd):
        out.dense(f"query_head.cls_branches.{i}", _index(qh["cls_branches"], i))
        reg = _index(qh["reg_branches"], i)
        for li in range(n_lin):
            out.dense(f"query_head.reg_branches.{i}.{2 * li}", reg[f"layers_{li}"])
    out.dense(f"query_head.cls_branches.{nd}", qh[f"cls_branches_{nd}"])
    for li in range(n_lin):
        out.dense(f"query_head.reg_branches.{nd}.{2 * li}", qh[f"reg_branches_{nd}"][f"layers_{li}"])

    t, key = qh["transformer"], "query_head.transformer"
    out.sd[f"{key}.level_embeds"] = _np(t["level_embeds"])
    out.dense(f"{key}.enc_output", t["enc_output"])
    out.norm(f"{key}.enc_output_norm", t["enc_output_norm"])
    out.sd[f"{key}.query_embed.weight"] = _np(t["query_embed"])

    for layer in range(tc.num_encoder_layers):
        e, k = _index(t["encoder_layers"], layer), f"{key}.encoder.layers.{layer}"
        out.msda(f"{k}.attentions.0", e["self_attn"])
        out.norm(f"{k}.norms.0", e["norm1"])
        out.norm(f"{k}.norms.1", e["norm2"])
        out.ffn(f"{k}.ffns.0", e["ffn"])

    dec = t["decoder"]
    for layer in range(nd):
        d, k = _index(dec["layers"], layer), f"{key}.decoder.layers.{layer}"
        sa = d["self_attn"]
        names = ("q_proj", "k_proj", "v_proj")
        out.sd[f"{k}.attentions.0.attn.in_proj_weight"] = np.concatenate(
            [_lin(sa[n]["kernel"]) for n in names]
        )
        out.sd[f"{k}.attentions.0.attn.in_proj_bias"] = np.concatenate(
            [_np(sa[n]["bias"]) for n in names]
        )
        out.dense(f"{k}.attentions.0.attn.out_proj", sa["out_proj"])
        out.msda(f"{k}.attentions.1", d["cross_attn"])
        for n in range(3):
            out.norm(f"{k}.norms.{n}", d[f"norm{n + 1}"])
        out.ffn(f"{k}.ffns.0", d["ffn"])
    for li, ti in enumerate((0, 2)):
        out.dense(f"{key}.decoder.ref_point_head.{ti}", dec["ref_point_head"][f"layers_{li}"])
    out.norm(f"{key}.decoder.norm", dec["norm"])


def state_dict_from_jax(params, cfg: CoDETRConfig) -> Dict[str, np.ndarray]:
    """JAX-package params tree -> {mmdet key: numpy array}."""
    p = params["params"] if "params" in params else params
    if cfg.backbone_type != "swin":
        raise NotImplementedError(f"backbone {cfg.backbone_type!r} is not ported yet")
    out = _Out()
    _swin(out, p, cfg)
    _neck(out, p, cfg)
    _head(out, p, cfg)
    return out.sd
