"""Co-DINO two-stage transformer, batch-first.

- encoder layer: MSDA self-attn -> LN -> FFN -> LN (post-norm)
- decoder layer: MHA self-attn -> LN -> MSDA cross-attn -> LN -> FFN -> LN

The layers run as Python loops over ``nn.ModuleList``s whose names follow
mmdet's checkpoint keys (``encoder.layers.N``, ``decoder.layers.N``,
``attentions.0/1``, ``norms.0-2``, ``ffns.0``).  Invalid-proposal masking
uses ``torch.where``, so padded keys whose reference point exceeds 1 never
turn into nan*0.  Reference points and box refinement stay float32.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from codetr_torch.config import TransformerConfig
from codetr_torch.models.layers import FFN, LN_EPS, MultiheadAttention, mlp
from codetr_torch.models.msda_module import MultiScaleDeformableAttention
from codetr_torch.models.positional_encoding import gen_sineembed_for_position

Shapes = Tuple[Tuple[int, int], ...]


def get_valid_ratio(mask: torch.Tensor) -> torch.Tensor:
    """(bs, H, W) pad mask -> (bs, 2) [w_ratio, h_ratio]."""
    H, W = mask.shape[1], mask.shape[2]
    valid_h = (1.0 - mask[:, :, 0].float()).sum(1)
    valid_w = (1.0 - mask[:, 0, :].float()).sum(1)
    return torch.stack([valid_w / W, valid_h / H], dim=-1)


def get_reference_points(spatial_shapes: Shapes, valid_ratios: torch.Tensor) -> torch.Tensor:
    """Per-key normalised pixel centres (bs, K, 2) xy."""
    refs = []
    dev = valid_ratios.device
    for lvl, (H, W) in enumerate(spatial_shapes):
        ref_y, ref_x = torch.meshgrid(
            torch.linspace(0.5, H - 0.5, H, dtype=torch.float32, device=dev),
            torch.linspace(0.5, W - 0.5, W, dtype=torch.float32, device=dev),
            indexing="ij",
        )
        ref_y = ref_y.reshape(1, -1) / (valid_ratios[:, lvl, 1:2] * H)
        ref_x = ref_x.reshape(1, -1) / (valid_ratios[:, lvl, 0:1] * W)
        refs.append(torch.stack((ref_x, ref_y), dim=-1))
    return torch.cat(refs, dim=1)


def make_encoder_output_proposals(reference_points: torch.Tensor, spatial_shapes: Shapes) -> torch.Tensor:
    """(bs, K, 2) -> unactivated (bs, K, 4) proposals, widths 0.05 * 2^lvl.
    Entries outside (0, 1) give non-finite logits, masked downstream."""
    width = torch.cat([
        torch.full((h * w,), 0.05 * 2.0**lvl, dtype=reference_points.dtype, device=reference_points.device)
        for lvl, (h, w) in enumerate(spatial_shapes)
    ])
    bs, K, _ = reference_points.shape
    width = width[None, :, None].expand(bs, K, 1)
    proposals = torch.cat([reference_points, width, width], dim=-1)
    return torch.log(proposals / (1.0 - proposals))


def apply_mask_to_proposal_and_memory(output_proposals, memory, memory_padding_mask):
    """Proposals outside logit range +-4.6 or at padded keys become float32
    max; memory at those keys becomes zero."""
    in_bounds = ((output_proposals > -4.6) & (output_proposals < 4.6)).all(-1, keepdim=True)
    valid = in_bounds & ~memory_padding_mask[..., None].bool()
    big = torch.finfo(torch.float32).max
    proposals = torch.where(valid, output_proposals, torch.full_like(output_proposals, big))
    out_memory = torch.where(valid, memory, torch.zeros_like(memory))
    return proposals, out_memory


def _layer_norm(dims: int) -> nn.LayerNorm:
    return nn.LayerNorm(dims, eps=LN_EPS)


class DetrTransformerEncoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, msda_impl: str = "auto"):
        super().__init__()
        E = cfg.embed_dims
        self.attentions = nn.ModuleList(
            [MultiScaleDeformableAttention(cfg.encoder_layer.attn, grid_queries=True, impl=msda_impl)]
        )
        self.norms = nn.ModuleList([_layer_norm(E) for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(E, cfg.encoder_layer.feedforward_channels)])

    def forward(self, query, query_pos, key_padding_mask, reference_points, spatial_shapes):
        query = self.attentions[0](
            query, query, query_pos, key_padding_mask, reference_points, spatial_shapes
        )
        query = self.norms[0](query)
        query = self.ffns[0](query)
        return self.norms[1](query)


class DetrTransformerEncoder(nn.Module):
    def __init__(self, cfg: TransformerConfig, msda_impl: str = "auto"):
        super().__init__()
        self.layers = nn.ModuleList(
            DetrTransformerEncoderLayer(cfg, msda_impl) for _ in range(cfg.num_encoder_layers)
        )

    def forward(self, query, query_pos, key_padding_mask, reference_points, spatial_shapes):
        for layer in self.layers:
            query = layer(query, query_pos, key_padding_mask, reference_points, spatial_shapes)
        return query


class DetrTransformerDecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerConfig, msda_impl: str = "auto"):
        super().__init__()
        E = cfg.embed_dims
        self.attentions = nn.ModuleList([
            MultiheadAttention(E, cfg.decoder_layer.self_attn_heads),
            # a grid impl raises here: the decoder's queries are not the grid
            MultiScaleDeformableAttention(cfg.decoder_layer.cross_attn, impl=msda_impl),
        ])
        self.norms = nn.ModuleList([_layer_norm(E) for _ in range(3)])
        self.ffns = nn.ModuleList([FFN(E, cfg.decoder_layer.feedforward_channels)])

    def forward(self, query, query_pos, memory, key_padding_mask, reference_points, spatial_shapes):
        query = self.norms[0](self.attentions[0](query, query_pos))
        query = self.attentions[1](
            query, memory, query_pos, key_padding_mask, reference_points, spatial_shapes
        )
        query = self.norms[1](query)
        return self.norms[2](self.ffns[0](query))


class DinoTransformerDecoder(nn.Module):
    """Iterative box refinement in unactivated space, per-layer
    intermediates, and the shared final LayerNorm applied to each of them."""

    def __init__(self, cfg: TransformerConfig, msda_impl: str = "auto"):
        super().__init__()
        E = cfg.embed_dims
        self.cfg = cfg
        self.layers = nn.ModuleList(
            DetrTransformerDecoderLayer(cfg, msda_impl) for _ in range(cfg.num_decoder_layers)
        )
        self.ref_point_head = mlp(2 * E, E, E, 2)
        self.norm = _layer_norm(E)

    def forward(self, query, memory, key_padding_mask, reference_points, spatial_shapes,
                valid_ratios, reg_branches):
        """reference_points: (bs, nq, 4) unactivated float32.  Returns the
        normed intermediate states (n_layers, bs, nq, C) and the refined
        unactivated references (n_layers, bs, nq, 4)."""
        E = self.cfg.embed_dims
        vr4 = torch.cat([valid_ratios, valid_ratios], dim=-1)  # (bs, L, 4)
        refs = reference_points.float()
        states, inter_refs = [], []
        for lid, layer in enumerate(self.layers):
            ref_input = refs.sigmoid()[:, :, None, :] * vr4[:, None]  # (bs, nq, L, 4)
            sine = gen_sineembed_for_position(ref_input[:, :, 0, :].to(query.dtype), E // 2)
            query_pos = self.ref_point_head(sine)
            query = layer(query, query_pos, memory, key_padding_mask, ref_input, spatial_shapes)
            refs = reg_branches[lid](query).float() + refs
            states.append(query)
            inter_refs.append(refs)
        return self.norm(torch.stack(states)), torch.stack(inter_refs)


class CoDinoTransformer(nn.Module):
    """Flatten levels -> encoder -> two-stage top-k proposals -> decoder.

    ``msda_impl`` goes to every MSDA layer.  The grid impls ("grid",
    "grid_pallas") need grid queries, so only the encoder can take them:
    as in the JAX package, a transformer built with one raises in its
    decoder.  ``encode`` runs the encoder stage alone, optionally through
    another ``DetrTransformerEncoder`` (e.g. one with a grid impl carrying
    this encoder's weights)."""

    def __init__(self, cfg: TransformerConfig, msda_impl: str = "auto"):
        super().__init__()
        E = cfg.embed_dims
        self.cfg = cfg
        self.level_embeds = nn.Parameter(torch.empty(cfg.num_feature_levels, E))
        self.encoder = DetrTransformerEncoder(cfg, msda_impl)
        self.decoder = DinoTransformerDecoder(cfg, msda_impl)
        self.enc_output = nn.Linear(E, E)
        self.enc_output_norm = _layer_norm(E)
        self.query_embed = nn.Embedding(cfg.two_stage_num_proposals, E)

    def encode(
        self,
        mlvl_feats: Sequence[torch.Tensor],  # NCHW per level
        mlvl_masks: Sequence[torch.Tensor],  # (bs, h, w) bool, True = pad
        mlvl_pos_embeds: Sequence[torch.Tensor],  # (bs, h, w, C)
        encoder: Optional[DetrTransformerEncoder] = None,
    ):
        """The encoder stage: flatten the levels, add the level embeddings
        to the positional ones, valid ratios, per-level reference points,
        then the encoder (``self.encoder`` unless one is given) -> (memory
        (bs, K, C), mask_flat (bs, K), spatial_shapes, valid_ratios
        (bs, L, 2), reference_points (bs, K, 2))."""
        spatial_shapes: Shapes = tuple((f.shape[2], f.shape[3]) for f in mlvl_feats)
        feat_flat = torch.cat([f.flatten(2).transpose(1, 2) for f in mlvl_feats], dim=1)
        mask_flat = torch.cat([m.flatten(1) for m in mlvl_masks], dim=1)
        pos_flat = torch.cat(
            [p.flatten(1, 2) + self.level_embeds[lvl] for lvl, p in enumerate(mlvl_pos_embeds)],
            dim=1,
        )
        valid_ratios = torch.stack([get_valid_ratio(m) for m in mlvl_masks], dim=1)  # (bs, L, 2)
        reference_points = get_reference_points(spatial_shapes, valid_ratios)  # (bs, K, 2)
        ref_by_level = reference_points[:, :, None, :] * valid_ratios[:, None, :, :]
        encoder = self.encoder if encoder is None else encoder
        memory = encoder(feat_flat, pos_flat, mask_flat, ref_by_level, spatial_shapes)
        return memory, mask_flat, spatial_shapes, valid_ratios, reference_points

    def select_proposals(self, memory, mask_flat, reference_points, spatial_shapes: Shapes,
                         reg_branches: nn.ModuleList, cls_branches: nn.ModuleList):
        """The two-stage proposal stage: each key's proposal, masked, the
        memory through ``enc_output`` and its norm, the encoder-stage class
        and box branches (index ``num_decoder_layers``), and the top
        ``two_stage_num_proposals`` keys by their best class logit ->
        (topk_coords_unact (bs, nq, 4), topk_idx (bs, nq), enc_class
        (bs, K, num_classes), enc_coord_unact (bs, K, 4))."""
        c = self.cfg
        output_proposals = make_encoder_output_proposals(reference_points, spatial_shapes)
        output_proposals, output_memory = apply_mask_to_proposal_and_memory(
            output_proposals, memory, mask_flat
        )
        output_memory = self.enc_output_norm(self.enc_output(output_memory))

        nd = c.num_decoder_layers  # branch nd serves the encoder stage
        enc_class = cls_branches[nd](output_memory)
        enc_coord_unact = reg_branches[nd](output_memory).float() + output_proposals

        topk = c.two_stage_num_proposals
        topk_idx = torch.topk(enc_class.float().max(-1)[0], topk, dim=1)[1]
        # the proposals enter the decoder as constants: its box losses reach
        # the encoder stage only through its own outputs, not through them
        topk_coords_unact = torch.gather(
            enc_coord_unact, 1, topk_idx[..., None].expand(-1, -1, 4)
        ).detach()
        return topk_coords_unact, topk_idx, enc_class, enc_coord_unact

    def forward(
        self,
        mlvl_feats: Sequence[torch.Tensor],  # NCHW per level
        mlvl_masks: Sequence[torch.Tensor],  # (bs, h, w) bool, True = pad
        mlvl_pos_embeds: Sequence[torch.Tensor],  # (bs, h, w, C)
        reg_branches: nn.ModuleList,
        cls_branches: nn.ModuleList,
    ):
        bs = mlvl_feats[0].shape[0]
        memory, mask_flat, spatial_shapes, valid_ratios, reference_points = self.encode(
            mlvl_feats, mlvl_masks, mlvl_pos_embeds)
        topk_coords_unact, topk_idx, enc_class, enc_coord_unact = self.select_proposals(
            memory, mask_flat, reference_points, spatial_shapes, reg_branches, cls_branches)
        query = self.query_embed.weight[None].expand(bs, -1, -1)

        inter_states, inter_refs = self.decoder(
            query, memory, mask_flat, topk_coords_unact, spatial_shapes, valid_ratios, reg_branches
        )
        aux = {
            "memory": memory,  # (bs, K, C) encoder output
            "inter_states": inter_states,  # (n_layers, bs, nq, C) after norm
            "inter_refs_unact": inter_refs,  # (n_layers, bs, nq, 4)
            "init_refs_unact": topk_coords_unact,  # (bs, nq, 4)
            "topk_idx": topk_idx,  # (bs, nq) keys picked as proposals
            "enc_class": enc_class,  # (bs, K, num_classes)
            "enc_coord_unact": enc_coord_unact,  # (bs, K, 4)
        }
        return inter_states[-1], inter_refs[-1], aux
