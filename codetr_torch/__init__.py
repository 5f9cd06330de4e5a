"""codetr_torch: Co-DETR (Co-DINO) inference and training in PyTorch with
hand-written CUDA kernels for Hopper (H100), a port of the JAX package
``codetr_tpu``.

Entry points run on the card unless the caller passes ``device="cpu"``::

    from codetr_torch import Inferencer, build_codetr, co_dino_swin_l
    model = build_codetr(co_dino_swin_l(), seed=0)
    detections = Inferencer(model, height=768, width=1152)(images)

    from codetr_torch.parallel.train import adamw, make_train_step
    step = make_train_step(model, adamw(model))
    loss = step(images, masks, gt_boxes, gt_labels, gt_valid)  # updates model
"""

from codetr_torch.config import co_dino_r50, co_dino_swin_l, tiny_test_config
from codetr_torch.inferencer import Detections, Inferencer
from codetr_torch.models.codetr import CoDETR, build_codetr

__all__ = [
    "CoDETR",
    "Detections",
    "Inferencer",
    "build_codetr",
    "co_dino_r50",
    "co_dino_swin_l",
    "tiny_test_config",
]
