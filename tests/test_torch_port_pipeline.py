"""The port's preprocess, NMS and Inferencer against the JAX package.

Inputs are made from a seed with numpy and handed to both packages.
Preprocess: mask, padding, scale factors and normalised pixels equal (the
port's integer resize is cv2 ``INTER_LINEAR``'s arithmetic).  NMS: keep masks equal, scores and boxes
to float32 rounding.  Inferencer: the tiny model with the same weights,
batch_size=2 over 3 images (so the last batch is padded), detections
matched set-wise (scores 2e-4, boxes 0.1 px).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import PreprocessConfig as JaxPreprocessConfig
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.inferencer import Inferencer as JaxInferencer
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.ops.nms import nms as jax_nms
from codetr_tpu.ops.nms import postprocess_detections as jax_postprocess
from codetr_tpu.ops.nms import soft_nms as jax_soft_nms
from codetr_tpu.utils.preprocess import preprocess_numpy
from codetr_torch.config import PreprocessConfig
from codetr_torch.inferencer import Inferencer
from codetr_torch.ops.nms import nms, postprocess_detections, soft_nms
from codetr_torch.utils.preprocess import preprocess

from test_torch_port_model import match_detections, perturbed_jax_params, port_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("size", [(48, 96), (300, 200), (31, 17), (128, 128), (97, 250)])
def test_preprocess_matches_jax_host_path(size):
    rng = np.random.default_rng(sum(size))
    img = rng.integers(0, 256, (*size, 3), np.uint8)
    want_x, want_mask, want_sf, want_thw = preprocess_numpy(img, 128, 160, JaxPreprocessConfig())
    x, mask, sf, thw = preprocess(img, 128, 160, PreprocessConfig(), device="cpu")
    assert thw == want_thw and sf == want_sf
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    th, tw = thw
    x = x.numpy()
    assert np.all(x[th:] == 0) and np.all(x[:, tw:] == 0)
    np.testing.assert_array_equal(x, want_x)


def random_detections(rng, bs, n, num_classes=3, size=100.0):
    """Clustered boxes so that suppression actually happens."""
    centers = rng.uniform(10, size - 10, (bs, 4, 2))
    pick = rng.integers(0, 4, (bs, n))
    c = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 3, (bs, n, 2))
    wh = rng.uniform(8, 30, (bs, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1).astype(np.float32)
    scores = rng.uniform(0, 1, (bs, n)).astype(np.float32)
    labels = rng.integers(0, num_classes, (bs, n)).astype(np.int32)
    return boxes, scores, labels


@pytest.mark.parametrize("nms_type,iou", [("nms", 0.5), ("soft_nms", 0.8), ("soft_nms", 0.3),
                                          ("soft_nms_gaussian", 0.8)])
def test_postprocess_matches_jax(nms_type, iou):
    rng = np.random.default_rng(7)
    boxes, scores, labels = random_detections(rng, 2, 40)
    sf = np.asarray([[[0.5, 0.8, 0.5, 0.8]], [[1.25, 1.0, 1.25, 1.0]]], np.float32)
    kw = dict(score_threshold=0.1, iou_threshold=iou, nms_type=nms_type, nms_sigma=0.5,
              nms_min_score=1e-3)
    jb, js, jl, jk = jax_postprocess(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels),
                                     scale_factor=jnp.asarray(sf), **kw)
    tb, ts, tl, tk = postprocess_detections(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels),
        scale_factor=torch.from_numpy(sf), **kw,
    )
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < tk.sum() < tk.numel(), "the case must suppress some boxes and keep others"
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_class_agnostic_nms_and_soft_nms_match_jax():
    rng = np.random.default_rng(3)
    boxes, scores, _ = random_detections(rng, 1, 30)
    b, s = boxes[0], scores[0]
    s[:3] = -np.inf  # padding entries never survive
    np.testing.assert_array_equal(
        nms(torch.from_numpy(b), torch.from_numpy(s), 0.5).numpy(),
        np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(s), 0.5)),
    )
    for method in ("linear", "gaussian"):
        got = soft_nms(torch.from_numpy(b), torch.from_numpy(s), 0.3, 0.5, 1e-3, method)
        want = jax_soft_nms(jnp.asarray(b), jnp.asarray(s), 0.3, 0.5, 1e-3, method=method)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_inferencer_matches_jax_with_a_padded_batch():
    params = perturbed_jax_params(seed=2)
    rng = np.random.default_rng(4)
    # sizes that need no resize at 128x128 (scale 1); resized images below
    images = [rng.integers(0, 256, s, np.uint8) for s in ((96, 128, 3), (128, 80, 3), (128, 128, 3))]

    cfg = jax_tiny_test_config()
    want = JaxInferencer(JaxCoDETR(cfg=cfg, msda_impl="auto"), params, cfg,
                         height=128, width=128, batch_size=2)(images)
    got = Inferencer(port_from_jax(params), height=128, width=128, batch_size=2,
                     device="cpu")(images)

    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.boxes.shape == w.boxes.shape and g.keep.shape == w.keep.shape
        gc, wc = g.compact(), w.compact()
        assert len(gc.scores) == len(wc.scores)
        assert match_detections(gc.boxes, gc.labels, wc.boxes, wc.labels, box_tol=0.1) == 0
        np.testing.assert_allclose(np.sort(gc.scores), np.sort(wc.scores), atol=2e-4)


def test_inferencer_matches_jax_on_resized_images():
    """Images that need a keep-ratio resize to 128x128 (down and up, both
    orientations): the port's resize must give cv2 ``INTER_LINEAR``'s pixels
    for the detections to match the JAX ``Inferencer`` set-wise at the
    ladder (scores 2e-4, boxes 0.1 px)."""
    params = perturbed_jax_params(seed=2)
    rng = np.random.default_rng(5)
    images = [rng.integers(0, 256, s, np.uint8) for s in ((200, 300, 3), (150, 100, 3), (61, 97, 3))]

    cfg = jax_tiny_test_config()
    want = JaxInferencer(JaxCoDETR(cfg=cfg, msda_impl="auto"), params, cfg,
                         height=128, width=128, batch_size=2)(images)
    got = Inferencer(port_from_jax(params), height=128, width=128, batch_size=2,
                     device="cpu")(images)

    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        gc, wc = g.compact(), w.compact()
        assert len(gc.scores) == len(wc.scores)
        assert match_detections(gc.boxes, gc.labels, wc.boxes, wc.labels, box_tol=0.1) == 0
        np.testing.assert_allclose(np.sort(gc.scores), np.sort(wc.scores), atol=2e-4)
