"""Python-dict config files with ``_base_`` inheritance -> ``CoDETRConfig``.

An independent copy of the JAX package's loader, so that this package
imports nothing from it.  A config file is a python module defining plain
variables; a ``_base_`` string or list pulls in parent files whose dicts are
merged recursively (the child wins; ``{'_delete_': True}`` replaces instead
of merging), as mmengine's ``Config.fromfile`` does.  ``load_config_file``
maps the mmdet-style model dict onto the port's config, reading the keys the
port's config keeps and ignoring the rest (training-only sections, dropout,
the pretrain size, the co-head flags, the query count).
"""

from __future__ import annotations

import os
import runpy
from typing import Any, Dict

from codetr_torch.config import (
    CoDETRConfig,
    DecoderLayerConfig,
    EncoderLayerConfig,
    HeadConfig,
    MSDAConfig,
    NeckConfig,
    PositionalEncodingConfig,
    ResNetConfig,
    SwinConfig,
    TransformerConfig,
)


def _merge(base: Any, child: Any) -> Any:
    if isinstance(child, dict) and child.pop("_delete_", False):
        return child
    if isinstance(base, dict) and isinstance(child, dict):
        out = dict(base)
        for k, v in child.items():
            out[k] = _merge(base[k], v) if k in base else v
        return out
    return child


def load_dict_config(path: str) -> Dict[str, Any]:
    """Execute a python config file, resolving ``_base_`` chains."""
    ns = runpy.run_path(path)
    cfg = {k: v for k, v in ns.items() if not k.startswith("__")}
    bases = cfg.pop("_base_", [])
    if isinstance(bases, str):
        bases = [bases]
    merged: Dict[str, Any] = {}
    for b in bases:
        merged = _merge(merged, load_dict_config(os.path.join(os.path.dirname(path), b)))
    return _merge(merged, cfg)


def _build_msda(d: dict) -> MSDAConfig:
    return MSDAConfig(
        embed_dims=d.get("embed_dims", 256),
        num_heads=d.get("num_heads", 8),
        num_levels=d.get("num_levels", 5),
        num_points=d.get("num_points", 4),
    )


def model_dict_to_config(model: dict) -> CoDETRConfig:
    """mmdet-style model dict -> ``CoDETRConfig`` (inference keys only)."""
    backbone = dict(model["backbone"])
    btype = backbone.pop("type")
    swin = resnet = None
    if btype == "SwinTransformer":
        backbone_type = "swin"
        swin = SwinConfig(
            embed_dims=backbone.get("embed_dims", 192),
            depths=tuple(backbone.get("depths", (2, 2, 18, 2))),
            num_heads=tuple(backbone.get("num_heads", (6, 12, 24, 48))),
            window_size=backbone.get("window_size", 12),
            mlp_ratio=backbone.get("mlp_ratio", 4),
            qkv_bias=backbone.get("qkv_bias", True),
            qk_scale=backbone.get("qk_scale"),
            out_indices=tuple(backbone.get("out_indices", (0, 1, 2, 3))),
        )
    elif btype == "ResNet":
        backbone_type = "resnet"
        resnet = ResNetConfig(
            depth=backbone.get("depth", 50),
            num_stages=backbone.get("num_stages", 4),
            out_indices=tuple(backbone.get("out_indices", (0, 1, 2, 3))),
        )
    else:
        raise ValueError(f"unsupported backbone type {btype!r}")

    neck_d = model["neck"]
    neck = NeckConfig(
        in_channels=tuple(neck_d["in_channels"]),
        out_channels=neck_d.get("out_channels", 256),
        kernel_size=neck_d.get("kernel_size", 1),
        num_outs=neck_d.get("num_outs", 5),
        num_groups=neck_d.get("norm_cfg", {}).get("num_groups", 32),
    )

    qh = model["query_head"]
    tf_d = qh["transformer"]
    enc_d, dec_d = tf_d["encoder"], tf_d["decoder"]
    enc_attn = _build_msda(enc_d["transformerlayers"]["attn_cfgs"])
    dec_attns = dec_d["transformerlayers"]["attn_cfgs"]
    tf = TransformerConfig(
        embed_dims=enc_attn.embed_dims,
        num_feature_levels=tf_d.get("num_feature_levels", 5),
        two_stage_num_proposals=qh.get("num_query", 900),
        num_encoder_layers=enc_d.get("num_layers", 6),
        num_decoder_layers=dec_d.get("num_layers", 6),
        encoder_layer=EncoderLayerConfig(
            attn=enc_attn,
            feedforward_channels=enc_d["transformerlayers"].get("feedforward_channels", 2048),
        ),
        decoder_layer=DecoderLayerConfig(
            self_attn_heads=dec_attns[0].get("num_heads", 8),
            cross_attn=_build_msda(dec_attns[1]),
            feedforward_channels=dec_d["transformerlayers"].get("feedforward_channels", 2048),
        ),
    )
    pe = qh.get("positional_encoding", {})
    head = HeadConfig(
        num_classes=qh.get("num_classes", 80),
        transformer=tf,
        positional_encoding=PositionalEncodingConfig(
            num_feats=pe.get("num_feats", 128),
            temperature=pe.get("temperature", 20),
            normalize=pe.get("normalize", True),
        ),
        max_per_img=(model.get("test_cfg") or [{}])[0].get("max_per_img", 300),
    )
    return CoDETRConfig(backbone_type=backbone_type, swin=swin, resnet=resnet, neck=neck, head=head)


def load_config_file(path: str) -> CoDETRConfig:
    """Config file -> ``CoDETRConfig``; the model's type must be CoDETR."""
    model = dict(load_dict_config(path)["model"])
    mtype = model.pop("type", "CoDETR")
    if mtype != "CoDETR":
        raise ValueError(f"model type must be CoDETR, got {mtype!r}")
    return model_dict_to_config(model)
