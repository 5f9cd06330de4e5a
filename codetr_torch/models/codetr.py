"""Top-level CoDETR model: Swin or ResNet backbone -> ChannelMapper neck ->
CoDINO head.

The public image layout stays NHWC: ``batch_inputs`` is (bs, H, W, 3)
normalised images and ``img_masks`` is (bs, H, W) with 1.0 in the padded
region.  The result is (boxes (bs, max_per_img, 4) xyxy pixels, scores,
labels).  ``state_dict()`` keys are mmdet's, so an mmdet checkpoint or the
JAX package's params (``utils.checkpoint.state_dict_from_jax``) load as
they are.

An fp32 model computes in full fp32 on the card: its entry points
(``forward``, ``features``, ``detect``, ``train_outputs``) run under
``full_fp32``, which turns TF32 off for cuDNN's convolutions (on by default
in PyTorch) and for matmuls, and gives the caller's flags back on exit.  A
bf16 model leaves the flags alone.

A bf16 model (``build_codetr(dtype=torch.bfloat16)``, ``to_compute_dtype``)
holds its parameters as the JAX package's bf16 model uses them: in bf16
those it casts at use (every Linear, convolution and embedding, the level
embeddings), in float32 those it uses in float32 (``fp32_parameter_names``:
the norms' and the frozen BatchNorm's tensors, Swin's relative-position
bias tables).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Tuple

import torch
from torch import nn

from codetr_torch.config import CoDETRConfig
from codetr_torch.models.channel_mapper import ChannelMapper
from codetr_torch.models.co_dino_head import CoDINOHead
from codetr_torch.models.msda_module import MultiScaleDeformableAttention, grid_offset_bias
from codetr_torch.models.resnet import FrozenBatchNorm2d, ResNet
from codetr_torch.models.swin import SwinTransformer, WindowMSA


@contextlib.contextmanager
def full_fp32():
    """Convolutions and matmuls in full fp32 (no TF32) inside the scope; the
    caller's cuDNN and matmul flags are restored on exit."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    allow_matmul = matmul.allow_tf32
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     benchmark_limit=cudnn.benchmark_limit, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        matmul.allow_tf32 = False
        try:
            yield
        finally:
            matmul.allow_tf32 = allow_matmul


def fp32_scope(dtype: torch.dtype):
    """``full_fp32()`` for an fp32 model, no change for any other dtype."""
    return full_fp32() if dtype == torch.float32 else contextlib.nullcontext()


def _in_model_precision(method):
    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        with fp32_scope(self.dtype):
            return method(self, *args, **kwargs)
    return wrapped


class CoDETR(nn.Module):
    def __init__(self, cfg: CoDETRConfig, msda_impl: str = "auto"):
        super().__init__()
        if cfg.backbone_type == "swin":
            self.backbone = SwinTransformer(cfg.swin)
        elif cfg.backbone_type == "resnet":
            self.backbone = ResNet(cfg.resnet)
        else:
            raise ValueError(f"unknown backbone {cfg.backbone_type!r}")
        self.cfg = cfg
        self.neck = ChannelMapper(cfg.neck)
        self.query_head = CoDINOHead(cfg.head, msda_impl)

    @property
    def dtype(self) -> torch.dtype:
        return self.query_head.transformer.level_embeds.dtype

    @_in_model_precision
    def features(self, batch_inputs: torch.Tensor) -> List[torch.Tensor]:
        """(bs, H, W, 3) -> NCHW neck features, one per level."""
        return self.neck(self.backbone(batch_inputs.to(self.dtype)))

    @_in_model_precision
    def detect(self, feats: List[torch.Tensor], img_masks: torch.Tensor):
        return self.query_head(feats, img_masks)

    @_in_model_precision
    def forward(self, batch_inputs: torch.Tensor, img_masks: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.detect(self.features(batch_inputs), img_masks)

    @_in_model_precision
    def train_outputs(self, batch_inputs: torch.Tensor, img_masks: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        """Per-decoder-layer and encoder-stage class logits and cxcywh boxes
        for the training losses (``parallel.losses.dino_detection_loss``)."""
        return self.query_head.raw_predictions(self.features(batch_inputs), img_masks)


def fp32_parameter_names(model: nn.Module) -> set:
    """Names of the parameters and buffers that the JAX package uses in
    float32 in every compute dtype: the affine parameters of LayerNorm and
    GroupNorm (flax normalises in float32 on ``param_dtype=float32``
    parameters), the frozen BatchNorm's four tensors (applied in float32)
    and Swin's relative-position bias tables (added to float32 logits).
    The JAX package casts every other parameter to the compute dtype where
    it uses it, which a parameter held in that dtype gives as well."""
    names = set()
    for prefix, m in model.named_modules():
        prefix = prefix + "." if prefix else ""
        if isinstance(m, (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm2d)):
            names.update(prefix + n for n, _ in m.named_parameters(recurse=False))
            names.update(prefix + n for n, _ in m.named_buffers(recurse=False))
        elif isinstance(m, WindowMSA):
            names.add(prefix + "relative_position_bias_table")
    return names


@torch.no_grad()
def to_compute_dtype(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast ``model``'s floating parameters and buffers to ``dtype`` in
    place, except ``fp32_parameter_names``' (kept float32)."""
    keep = fp32_parameter_names(model)
    for prefix, m in model.named_modules():
        prefix = prefix + "." if prefix else ""
        for n, p in m.named_parameters(recurse=False):
            if p.is_floating_point() and prefix + n not in keep:
                p.data = p.data.to(dtype)
        for n, b in m.named_buffers(recurse=False):
            if b.is_floating_point() and prefix + n not in keep:
                m._buffers[n] = b.to(dtype)
    return model


def check_device(device) -> torch.device:
    """The device an entry point runs on; CUDA without a card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return device


@torch.no_grad()
def init_weights(model: CoDETR, seed: int = 0) -> CoDETR:
    """Seeded random init, drawn on the CPU from one ``torch.Generator``:
    Linear/Conv weights ~ N(0, 1/fan_in), biases ~ U(-0.05, 0.05), norms
    (frozen BatchNorm included) at identity, bias tables ~ N(0, 0.02),
    embeddings ~ N(0, 1).  MSDA gets
    mmdet's grid offset bias and small random offset/weight projections,
    so sampling locations vary per query."""
    g = torch.Generator().manual_seed(seed)
    init_module_weights(model, g)
    qh = model.query_head
    qh.transformer.level_embeds.copy_(torch.randn(qh.transformer.level_embeds.shape, generator=g))
    for attn in (layer.attentions[0].attn for layer in qh.transformer.decoder.layers):
        fan_in = attn.in_proj_weight.shape[1]
        attn.in_proj_weight.copy_(torch.randn(attn.in_proj_weight.shape, generator=g) * fan_in**-0.5)
        attn.in_proj_bias.copy_(torch.rand(attn.in_proj_bias.shape, generator=g) * 0.1 - 0.05)
    return model


@torch.no_grad()
def init_module_weights(module: nn.Module, g: torch.Generator) -> None:
    """``init_weights``' draws for the layers of ``module`` (any module,
    the model or a standalone block), in module order from ``g``: first
    every Linear, Conv and Embedding, then the window-attention bias
    tables; MSDA projections set as ``init_weights`` says."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * fan_in**-0.5)
            if m.bias is not None:
                m.bias.copy_(torch.rand(m.bias.shape, generator=g) * 0.1 - 0.05)
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm2d):
            for t, v in ((m.weight, 1.0), (m.bias, 0.0), (m.running_mean, 0.0), (m.running_var, 1.0)):
                t.fill_(v)
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g))
    for m in module.modules():
        if isinstance(m, MultiScaleDeformableAttention):
            c = m.cfg
            m.sampling_offsets.weight.mul_(0.02)
            m.sampling_offsets.bias.copy_(grid_offset_bias(c.num_heads, c.num_levels, c.num_points))
            m.attention_weights.weight.mul_(0.1)
        elif isinstance(m, WindowMSA):
            t = m.relative_position_bias_table
            t.copy_(torch.randn(t.shape, generator=g) * 0.02)


def build_codetr(
    cfg: CoDETRConfig,
    weights: str | None = None,
    *,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    seed: int = 0,
    msda_impl: str = "auto",
) -> CoDETR:
    """Build the model with seeded random weights, in eval mode, on
    ``device`` (CUDA by default; raises if there is no card) in ``dtype``
    (``to_compute_dtype``: a bf16 model keeps ``fp32_parameter_names``'
    tensors float32).
    ``weights``: an mmdet ``.pth`` loaded over them
    (``utils.checkpoint.load_torch_checkpoint``, which raises ``KeyError``
    on a file that lacks a key of the model, so every weight comes from the
    file).  ``msda_impl`` goes to every MSDA
    layer; the grid impls raise in the decoder, as the JAX package's
    ``build_codetr`` does."""
    device = check_device(device)
    model = init_weights(CoDETR(cfg, msda_impl), seed)
    if weights is not None:
        from codetr_torch.utils.checkpoint import load_torch_checkpoint

        sd = load_torch_checkpoint(weights, cfg)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return to_compute_dtype(model.to(device=device), dtype).eval()
