"""fp32 means fp32: the port's fp32 entry points turn TF32 off for cuDNN and
for matmuls while they run, and give the caller's flags back after.

PyTorch leaves ``torch.backends.cudnn.allow_tf32`` at True, so without the
scope an fp32 model's convolutions (R50's backbone, Swin's patch embedding,
the ChannelMapper) would run in TF32 on the card.  The flags are global, so
the scope is visible on the CPU too: a forward hook on a convolution reads
them while the model runs.  A bf16 model leaves them alone.
"""

import numpy as np
import pytest
import torch

from codetr_torch import build_codetr, tiny_test_config
from codetr_torch.parallel.train import adamw, make_train_step
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

H = W = 128


@pytest.fixture
def caller_flags(request):
    """The caller's (cuDNN, matmul) TF32 flags for the test, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = request.param
    yield request.param
    cudnn.allow_tf32, matmul.allow_tf32 = saved


def flags_seen_by_a_convolution(model):
    """Records (cuDNN, matmul) TF32 flags each time the model's first
    convolution runs."""
    seen = []
    conv = next(m for m in model.modules() if isinstance(m, torch.nn.Conv2d))
    conv.register_forward_hook(
        lambda *_: seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    return seen


def inputs():
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.standard_normal((1, H, W, 3)).astype(np.float32))
    mask = torch.zeros(1, H, W)
    mask[:, 100:] = 1.0
    return img, mask


def targets(num_classes):
    boxes = torch.tensor([[[0.4, 0.4, 0.2, 0.3], [0.6, 0.3, 0.1, 0.1]]])
    return boxes, torch.tensor([[1, num_classes - 1]]), torch.tensor([[True, False]])


@pytest.mark.parametrize("caller_flags", [(True, False), (False, True), (True, True)], indirect=True)
def test_fp32_forward_and_train_step_pin_full_fp32(caller_flags):
    """During an fp32 forward (and its ``features`` / ``train_outputs``) and
    during a train step the convolution sees both flags False; after each,
    the caller's values are back."""
    cfg = tiny_test_config()
    model = build_codetr(cfg, device="cpu", seed=0)
    seen = flags_seen_by_a_convolution(model)
    img, mask = inputs()
    with torch.no_grad():
        model(img, mask)
        model.features(img)
        model.train_outputs(img, mask)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == caller_flags
    step = make_train_step(model, adamw(model))
    loss = step(img, mask, *targets(cfg.head.num_classes))
    assert torch.isfinite(loss)
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == caller_flags
    assert len(seen) == 4 and all(s == (False, False) for s in seen), seen


@pytest.mark.parametrize("caller_flags", [(True, False)], indirect=True)
def test_bf16_model_leaves_the_flags_alone(caller_flags):
    model = build_codetr(tiny_test_config(), dtype=torch.bfloat16, device="cpu", seed=0)
    seen = flags_seen_by_a_convolution(model)
    img, mask = inputs()
    with torch.no_grad():
        model(img, mask)
    assert seen == [caller_flags]
