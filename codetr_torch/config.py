"""Typed configuration for the PyTorch/CUDA port.

An independent copy of the inference-relevant dataclasses of the JAX
package's ``config.py``, so that this package imports nothing from it.
Field names and defaults are the same.  Fields that the port never reads
are left out: the TPU kernel's window-envelope sizing and im2col step (the
CUDA kernels are exact for every tap), dropout and stochastic depth (the
JAX package's training path runs without them too), and the unused
pretrain size, stage strides, co-head flags, query count and BGR flag.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class SwinConfig:
    """Swin Transformer backbone; Swin-L defaults
    (configs/co_dino_5scale_swin_l_16xb1_16e_o365tococo.py)."""

    in_channels: int = 3
    embed_dims: int = 192
    patch_size: int = 4
    window_size: int = 12
    mlp_ratio: int = 4
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    # gradient checkpointing for training: each Swin block's activations
    # are recomputed in the backward pass
    with_cp: bool = False

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(int(self.embed_dims * 2**i) for i in range(len(self.depths)))


@dataclass(frozen=True)
class ResNetConfig:
    """ResNet backbone (co_dino_5scale_r50_lsj)."""

    depth: int = 50
    in_channels: int = 3
    stem_channels: int = 64
    base_channels: int = 64
    num_stages: int = 4
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    style: str = "pytorch"

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}[self.depth]

    @property
    def num_features(self) -> Tuple[int, ...]:
        return tuple(self.base_channels * 4 * 2**i for i in range(self.num_stages))


@dataclass(frozen=True)
class NeckConfig:
    """ChannelMapper neck: 1x1 conv + GN per level, one extra stride-2 level."""

    in_channels: Tuple[int, ...] = (192, 384, 768, 1536)
    out_channels: int = 256
    kernel_size: int = 1
    num_outs: int = 5
    num_groups: int = 32


@dataclass(frozen=True)
class PositionalEncodingConfig:
    """SinePositionalEncoding (normalize=True, temperature 20)."""

    num_feats: int = 128
    temperature: float = 20.0
    normalize: bool = True
    scale: float = 6.283185307179586  # 2*pi
    eps: float = 1e-6
    offset: float = 0.0


@dataclass(frozen=True)
class MSDAConfig:
    """MultiScaleDeformableAttention."""

    embed_dims: int = 256
    num_heads: int = 8
    num_levels: int = 5
    num_points: int = 4
    value_proj_ratio: float = 1.0
    # window halo, in target-level px, of the shift-window encoder impls
    # ("grid", "grid_pallas"): 5 keeps every tap of mmdet's offset init
    # (|offset| <= num_points = 4) inside its window.  The JAX package's
    # correction_budget sizes its windowed kernel's sparse correction tier;
    # an exact kernel has no such tier, so the port has no such field.
    grid_radius: int = 5


@dataclass(frozen=True)
class EncoderLayerConfig:
    """Encoder layer: MSDA self-attn -> LN -> FFN -> LN."""

    attn: MSDAConfig = field(default_factory=MSDAConfig)
    feedforward_channels: int = 2048


@dataclass(frozen=True)
class DecoderLayerConfig:
    """Decoder layer: MHA self-attn -> LN -> MSDA cross-attn -> LN -> FFN -> LN."""

    self_attn_heads: int = 8
    cross_attn: MSDAConfig = field(default_factory=MSDAConfig)
    feedforward_channels: int = 2048


@dataclass(frozen=True)
class TransformerConfig:
    """CoDinoTransformer."""

    embed_dims: int = 256
    num_feature_levels: int = 5
    two_stage_num_proposals: int = 900
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    encoder_layer: EncoderLayerConfig = field(default_factory=EncoderLayerConfig)
    decoder_layer: DecoderLayerConfig = field(default_factory=DecoderLayerConfig)


@dataclass(frozen=True)
class HeadConfig:
    """CoDINOHead and its test-time postprocess (test_cfg: soft-NMS at iou
    0.8, no score gate)."""

    num_classes: int = 80
    num_reg_fcs: int = 2
    transformer: TransformerConfig = field(default_factory=TransformerConfig)
    positional_encoding: PositionalEncodingConfig = field(default_factory=PositionalEncodingConfig)
    max_per_img: int = 300
    use_sigmoid: bool = True
    nms_type: str = "soft_nms"  # "nms" | "soft_nms" | "soft_nms_gaussian"
    nms_iou_threshold: float = 0.8
    nms_sigma: float = 0.5
    nms_min_score: float = 1e-3
    score_threshold: float = 0.0


@dataclass(frozen=True)
class PreprocessConfig:
    """Mean/std normalisation of RGB input."""

    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)


@dataclass(frozen=True)
class CoDETRConfig:
    """Top-level model config."""

    backbone_type: str = "swin"  # "swin" | "resnet"
    swin: Optional[SwinConfig] = None
    resnet: Optional[ResNetConfig] = None
    neck: NeckConfig = field(default_factory=NeckConfig)
    head: HeadConfig = field(default_factory=HeadConfig)
    preprocess: PreprocessConfig = field(default_factory=PreprocessConfig)


def co_dino_swin_l() -> CoDETRConfig:
    """Co-DINO Swin-L 5-scale (o365->COCO), the flagship."""
    return CoDETRConfig(
        backbone_type="swin",
        swin=SwinConfig(),
        neck=NeckConfig(in_channels=(192, 384, 768, 1536)),
    )


def co_dino_r50() -> CoDETRConfig:
    """Co-DINO R50 5-scale (configs/co_dino_5scale_r50_lsj_8xb2_1x_coco.py)."""
    return CoDETRConfig(
        backbone_type="resnet",
        resnet=ResNetConfig(),
        neck=NeckConfig(in_channels=(256, 512, 1024, 2048)),
    )


def tiny_test_config(num_levels: int = 5) -> CoDETRConfig:
    """A miniature config for fast unit tests."""
    msda = MSDAConfig(embed_dims=32, num_heads=4, num_levels=num_levels, num_points=2)
    tf = TransformerConfig(
        embed_dims=32,
        num_feature_levels=num_levels,
        two_stage_num_proposals=12,
        num_encoder_layers=2,
        num_decoder_layers=2,
        encoder_layer=EncoderLayerConfig(attn=msda, feedforward_channels=64),
        decoder_layer=DecoderLayerConfig(self_attn_heads=4, cross_attn=msda, feedforward_channels=64),
    )
    head = HeadConfig(
        num_classes=7,
        transformer=tf,
        positional_encoding=PositionalEncodingConfig(num_feats=16),
        max_per_img=8,
    )
    swin = SwinConfig(
        embed_dims=8,
        depths=(2, 2, 2, 2),
        num_heads=(1, 2, 4, 8),
        window_size=4,
    )
    return CoDETRConfig(
        backbone_type="swin",
        swin=swin,
        neck=NeckConfig(in_channels=swin.num_features, out_channels=32, num_outs=num_levels),
        head=head,
    )


# the command-line tools' --config names
CONFIGS = {"swin-l": co_dino_swin_l, "r50": co_dino_r50, "tiny": tiny_test_config}
