"""The system under test, seen from the benchmark: what every forward
adapter (``perfbench/forwards/<forward>.py``, named by the configuration
file's ``forward``) shares.

- ``port_config(cfg)``: the port's ``CoDETRConfig`` with the configuration
  file's sizes;
- ``Tap``: sits between the port's ``Inferencer`` and its forward and keeps
  the forward's outputs, which the correctness check reads.

An adapter's ``build(cfg, state_dict, canvas, batch, device)`` returns the
``Inferencer`` serving the cell's canvas and batch and its ``Tap``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def port_config(cfg: dict):
    """The port's ``CoDETRConfig`` with the configuration file's sizes."""
    from codetr_torch import config as C

    bb, tf, head, m = cfg["backbone"], cfg["transformer"], cfg["head"], cfg["transformer"]["msda"]
    if bb["type"] == "swin":
        backbone = dict(backbone_type="swin", swin=C.SwinConfig(
            embed_dims=bb["embed_dims"], patch_size=bb["patch_size"], window_size=bb["window_size"],
            mlp_ratio=bb["mlp_ratio"], depths=tuple(bb["depths"]), num_heads=tuple(bb["num_heads"]),
            out_indices=tuple(bb["out_indices"])))
    else:
        backbone = dict(backbone_type="resnet", resnet=C.ResNetConfig(
            depth=bb["depth"], stem_channels=bb["stem_channels"], base_channels=bb["base_channels"],
            num_stages=bb["num_stages"], out_indices=tuple(bb["out_indices"])))
    msda = C.MSDAConfig(embed_dims=tf["embed_dims"], num_heads=m["num_heads"], num_levels=m["num_levels"],
                        num_points=m["num_points"], value_proj_ratio=m["value_proj_ratio"])
    transformer = C.TransformerConfig(
        embed_dims=tf["embed_dims"], num_feature_levels=tf["num_feature_levels"],
        two_stage_num_proposals=tf["two_stage_num_proposals"], num_encoder_layers=tf["num_encoder_layers"],
        num_decoder_layers=tf["num_decoder_layers"],
        encoder_layer=C.EncoderLayerConfig(attn=msda, feedforward_channels=tf["encoder_ffn"]),
        decoder_layer=C.DecoderLayerConfig(self_attn_heads=tf["decoder_self_attn_heads"], cross_attn=msda,
                                           feedforward_channels=tf["decoder_ffn"]))
    pe = head["positional_encoding"]
    return C.CoDETRConfig(
        **backbone,
        neck=C.NeckConfig(in_channels=tuple(cfg["neck"]["in_channels"]), out_channels=cfg["neck"]["out_channels"],
                          kernel_size=cfg["neck"]["kernel_size"], num_outs=cfg["neck"]["num_outs"],
                          num_groups=cfg["neck"]["num_groups"]),
        head=C.HeadConfig(
            num_classes=head["num_classes"], num_reg_fcs=head["num_reg_fcs"], transformer=transformer,
            positional_encoding=C.PositionalEncodingConfig(**pe), max_per_img=head["max_per_img"],
            nms_type=head["nms_type"], nms_iou_threshold=head["nms_iou_threshold"],
            nms_sigma=head["nms_sigma"], nms_min_score=head["nms_min_score"],
            score_threshold=head["score_threshold"]),
        preprocess=C.PreprocessConfig(mean=tuple(cfg["preprocess"]["mean"]), std=tuple(cfg["preprocess"]["std"])),
    )


class Tap:
    """Passes the Inferencer's forward calls to the program and, while
    ``recording``, keeps each call's outputs (boxes, scores, labels): the
    head's detections before NMS, which the correctness check reads."""

    def __init__(self, fn):
        self.fn = fn
        self.recording = False
        self.outputs: List[Tuple[torch.Tensor, ...]] = []

    def __call__(self, *args):
        out = self.fn(*args)
        if self.recording:
            self.outputs.append(out)
        return out
