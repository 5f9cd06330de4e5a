"""The port's batched postprocess (``codetr_torch/ops/nms.py``) against the
JAX package's ``postprocess_detections`` (its ``vmap`` over images), at a
served batch's size: 4 images, Swin-L's 300 detections each, 80 classes.

Inputs come from ``test_torch_port_cuda.postprocess_inputs`` (a numpy
seed): an image with every score below the threshold, ``-inf`` padding
rows, exact score ties across and within classes, and an image whose
coordinates are 13x the others'.  Keep masks and labels must be equal,
scores and boxes within 1e-6.  The batched core is also held against the
single-image public functions, and the ops it dispatches must hold no host
read and no host-to-device copy, so that one call can be captured in a
CUDA graph (the gpu tests capture it on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from codetr_tpu.ops.nms import postprocess_detections as jax_postprocess
from codetr_torch.ops.nms import batched_nms, postprocess_detections, soft_batched_nms

from test_torch_port_cuda import (NMS_TYPES, SCORE_THRESHOLD, assert_postprocess_close, postprocess_inputs,
                                  postprocess_kwargs, postprocess_on, tied_inputs)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

CASES = [("nms", 0.5), ("soft_nms", 0.8), ("soft_nms", 0.3), ("soft_nms_gaussian", 0.8)]


@pytest.mark.parametrize("nms_type,iou", CASES)
def test_postprocess_matches_jax_at_serving_size(nms_type, iou):
    arrays = postprocess_inputs()
    got = postprocess_on("cpu", arrays, nms_type, iou)
    boxes, scores, labels, sf = (jnp.asarray(a) for a in arrays)
    want = jax_postprocess(boxes, scores, labels, scale_factor=sf, **postprocess_kwargs(nms_type, iou))
    assert_postprocess_close(got, want)
    out_scores, keep = got[1].numpy(), got[3].numpy()
    assert not keep[0].any(), "image 0 scores below the threshold everywhere"
    assert not keep[1, -40:].any(), "padding rows never survive"
    gated = arrays[1] >= SCORE_THRESHOLD
    for j in (1, 2, 3):
        # NMS drops some gated boxes, soft-NMS decays some
        suppressed = (out_scores[j] != arrays[1][j]) & gated[j]
        assert keep[j].any() and suppressed.any(), "each image must keep boxes and suppress others"


@pytest.mark.parametrize("nms_type,iou", CASES)
def test_batched_core_matches_per_image_functions(nms_type, iou):
    """One loop over the batch gives each image what the single-image
    public functions give it alone (each image's own class offset)."""
    boxes, scores, labels, sf = (torch.from_numpy(a) for a in postprocess_inputs(seed=2))
    kw = postprocess_kwargs(nms_type, iou)
    out_boxes, out_scores, _, keep = postprocess_detections(boxes, scores, labels, scale_factor=sf, **kw)
    gated = torch.where(scores >= SCORE_THRESHOLD, scores, torch.full((), float("-inf")))
    for j in range(len(boxes)):
        if nms_type == "nms":
            want_keep = batched_nms(boxes[j], gated[j], labels[j], iou) & torch.isfinite(gated[j])
            want_scores = torch.where(want_keep, scores[j], torch.full((), float("-inf")))
        else:
            method = "gaussian" if nms_type.endswith("gaussian") else "linear"
            want_scores = soft_batched_nms(boxes[j], gated[j], labels[j], iou, kw["nms_sigma"],
                                           kw["nms_min_score"], method)
            want_keep = torch.isfinite(want_scores)
        np.testing.assert_array_equal(keep[j].numpy(), want_keep.numpy())
        np.testing.assert_allclose(out_scores[j].numpy(), want_scores.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(out_boxes[j].numpy(), (boxes[j] / sf[j]).numpy())


@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_tied_scores_take_the_first_index(nms_type):
    """Equal scores resolve to the first index (JAX's stable argsort and
    argmax): NMS keeps each group's first row, soft-NMS leaves it at 0.5;
    the JAX package agrees."""
    boxes, scores, labels, firsts = tied_inputs()
    arrays = (boxes, scores, labels, np.ones((2, 1, 4), np.float32))
    got = postprocess_on("cpu", arrays, nms_type)
    keep, s = got[3].numpy(), got[1].numpy()
    if nms_type == "nms":
        np.testing.assert_array_equal(keep, firsts)
    else:
        assert np.all(s[firsts] == 0.5) and np.all(s[~firsts] < 0.5)
    want = jax_postprocess(*(jnp.asarray(a) for a in arrays[:3]), scale_factor=jnp.asarray(arrays[3]),
                           **postprocess_kwargs(nms_type))
    assert_postprocess_close(got, want)


class HostOps(TorchDispatchMode):
    """Records the ops that read a tensor back to the host or make one from
    host data (what a CUDA-graph capture refuses), by name, and indexing
    with a boolean mask (whose result's size is read from the device)."""

    FORBIDDEN = {"aten._local_scalar_dense", "aten.item", "aten.nonzero", "aten.nonzero_static",
                 "aten.masked_select", "aten.is_nonzero", "aten.lift_fresh", "aten.lift_fresh_copy"}

    def __init__(self):
        super().__init__()
        self.ops, self.found = 0, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        self.ops += 1
        if name in self.FORBIDDEN:
            self.found.append(name)
        if name.startswith("aten.index") and any(
                t is not None and t.dtype == torch.bool for a in args if isinstance(a, (list, tuple)) for t in a):
            self.found.append(f"{name} with a boolean mask")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("nms_type", NMS_TYPES)
def test_postprocess_dispatches_no_host_read_or_copy(nms_type):
    """Every op the postprocess dispatches at bs 4, N 300 stays on the
    device: no ``.item()``, no ``nonzero``, no boolean-mask indexing, no
    tensor made from host data (``torch.tensor(-inf)`` is one)."""
    boxes, scores, labels, sf = (torch.from_numpy(a) for a in postprocess_inputs())
    with HostOps() as mode:
        postprocess_detections(boxes, scores, labels, scale_factor=sf, **postprocess_kwargs(nms_type))
    assert mode.ops > 300  # the whole loop was seen
    assert not mode.found, sorted(set(mode.found))
