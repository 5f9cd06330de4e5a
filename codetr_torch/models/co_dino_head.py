"""CoDINO detection head: per-level masks and sine positional encodings, the
CoDinoTransformer, the 7 cloned classification / regression branches
(indices 0-5 for the decoder layers, index 6 for the encoder stage), and the
top-k decode to (boxes xyxy in pixels, scores, labels)."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from codetr_torch.config import HeadConfig
from codetr_torch.models.layers import mlp, nearest_resize_mask, top_k
from codetr_torch.models.positional_encoding import sine_positional_encoding
from codetr_torch.models.transformer import CoDinoTransformer


class CoDINOHead(nn.Module):
    def __init__(self, cfg: HeadConfig, msda_impl: str = "auto"):
        super().__init__()
        if not cfg.use_sigmoid:
            raise ValueError("only the sigmoid classification head is implemented")
        self.cfg = cfg
        E = cfg.transformer.embed_dims
        num_pred = cfg.transformer.num_decoder_layers + 1
        self.cls_branches = nn.ModuleList(nn.Linear(E, cfg.num_classes) for _ in range(num_pred))
        self.reg_branches = nn.ModuleList(
            mlp(E, E, 4, cfg.num_reg_fcs + 1) for _ in range(num_pred)
        )
        self.transformer = CoDinoTransformer(cfg.transformer, msda_impl)

    def level_masks_and_pos(self, mlvl_feats: Sequence[torch.Tensor], img_masks: torch.Tensor):
        """Per level: the padding mask (bs, h, w) bool and its sine
        positional encoding (bs, h, w, C), the transformer's inputs beside
        the features."""
        dtype = mlvl_feats[0].dtype
        masks, pos = [], []
        for feat in mlvl_feats:
            m = nearest_resize_mask(img_masks, feat.shape[2], feat.shape[3]) != 0
            masks.append(m)
            pos.append(sine_positional_encoding(m, self.cfg.positional_encoding, dtype=dtype))
        return masks, pos

    def run_transformer(self, mlvl_feats: Sequence[torch.Tensor], img_masks: torch.Tensor):
        masks, pos = self.level_masks_and_pos(mlvl_feats, img_masks)
        return self.transformer(mlvl_feats, masks, pos, self.reg_branches, self.cls_branches)

    def raw_predictions(self, mlvl_feats: Sequence[torch.Tensor], img_masks: torch.Tensor):
        """Training-path outputs, float32: the class logits and cxcywh boxes
        of every decoder layer, ``all_cls_logits`` (nl, bs, nq, ncls) and
        ``all_coords`` (nl, bs, nq, 4), and of the encoder stage,
        ``enc_cls_logits`` (bs, K, ncls) and ``enc_coords`` (bs, K, 4): the
        tensors the DINO losses supervise."""
        _, _, aux = self.run_transformer(mlvl_feats, img_masks)
        states = aux["inter_states"]  # (nl, bs, nq, C), normed
        all_cls = torch.stack([self.cls_branches[i](s) for i, s in enumerate(states)])
        return {
            "all_cls_logits": all_cls.float(),
            "all_coords": aux["inter_refs_unact"].float().sigmoid(),
            "enc_cls_logits": aux["enc_class"].float(),
            "enc_coords": aux["enc_coord_unact"].float().sigmoid(),
        }

    def decode(self, final_state: torch.Tensor, final_refs_unact: torch.Tensor,
               image_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Last decoder state -> top-k (boxes xyxy in pixels, scores, labels)."""
        c = self.cfg
        image_height, image_width = image_hw
        lvl = c.transformer.num_decoder_layers - 1
        outputs_classes = self.cls_branches[lvl](final_state)
        # the final refs already hold reg_branches[lvl] of the pre-norm state;
        # the head adds it once more on the normed state (PARITY.md §2.1)
        tmp = self.reg_branches[lvl](final_state).float() + final_refs_unact
        outputs_coords = tmp.sigmoid()  # (bs, nq, 4) cxcywh

        bs = outputs_coords.shape[0]
        cls_score = outputs_classes.float().sigmoid()
        scores, indexes = top_k(cls_score.reshape(bs, -1), c.max_per_img, outputs_classes.dtype)
        labels = indexes % c.num_classes
        bbox_index = indexes // c.num_classes
        bbox_pred = torch.gather(outputs_coords, 1, bbox_index[..., None].expand(-1, -1, 4))

        cx, cy, w, h = bbox_pred.unbind(-1)
        boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)
        # (w, h, w, h) made on the device: a host-made tensor is a pageable
        # copy that a CUDA-graph capture of the forward refuses
        scale = torch.where(torch.arange(4, device=boxes.device) % 2 == 0,
                            float(image_width), float(image_height))
        boxes = torch.minimum(torch.clamp(boxes * scale, min=0.0), scale)
        return boxes, scores, labels

    def forward(
        self,
        mlvl_feats: Sequence[torch.Tensor],  # NCHW neck features
        img_masks: torch.Tensor,  # (bs, H, W) float, 1 = padded
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        final_state, final_refs_unact, _ = self.run_transformer(mlvl_feats, img_masks)
        return self.decode(final_state, final_refs_unact, img_masks.shape[-2:])
