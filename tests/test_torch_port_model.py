"""The port's tiny-config model against the JAX package, the weight carry
between the two, and the port's import and device rules.

The JAX side builds its own params (``build_codetr``), perturbed by seeded
noise so no projection stays at its zero init; ``state_dict_from_jax``
carries them into the port.  Both run the same float32 inputs at 128x128
with a padded mask; the JAX encoder runs its Pallas kernel in interpret
mode.  Tolerances are the JAX suite's ladder: features and states 1e-4
relative, scores 2e-4, boxes 0.1 px matched set-wise.
"""

import ast
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import co_dino_swin_l as jax_co_dino_swin_l
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.models.codetr import build_codetr as jax_build_codetr
from codetr_tpu.utils.checkpoint import convert_state_dict
from codetr_torch.config import co_dino_swin_l, tiny_test_config
from codetr_torch.models.codetr import CoDETR, build_codetr, init_weights
from codetr_torch.inferencer import Inferencer
from codetr_torch.utils.checkpoint import state_dict_from_jax
from codetr_torch.utils.preprocess import preprocess

REPO = Path(__file__).resolve().parent.parent
H = W = 128


def perturbed_jax_params(seed: int = 0, cfg=None, input_shape=(64, 64)):
    """JAX-package init of a model (the tiny one by default), every leaf
    + 0.05 N(0, 1)."""
    _, params = jax_build_codetr(cfg or jax_tiny_test_config(), msda_impl="reference",
                                 input_shape=input_shape, seed=seed)
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
        params,
    )


def port_from_jax(params, cfg=None) -> CoDETR:
    cfg = cfg or tiny_test_config()
    sd = state_dict_from_jax(params, cfg)
    model = CoDETR(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return model.eval()


def match_detections(t_boxes, t_labels, j_boxes, j_labels, box_tol):
    """Greedy set-wise match: each port detection to an unused JAX one with
    the same label within ``box_tol`` px; returns the unmatched count."""
    used = np.zeros(len(j_boxes), bool)
    unmatched = 0
    for b, lab in zip(t_boxes, t_labels):
        cand = np.where((j_labels == lab) & ~used)[0]
        d = np.abs(j_boxes[cand] - b).max(axis=1) if len(cand) else np.array([np.inf])
        if d.min() > box_tol:
            unmatched += 1
            continue
        used[cand[np.argmin(d)]] = True
    return unmatched


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-9)


@pytest.fixture(scope="module")
def jax_params():
    return perturbed_jax_params()


def assert_model_matches_jax(jax_cfg, port_cfg, params, h, w, seed=1):
    """The JAX ``CoDETR`` (``msda_impl="auto"``: K1 in interpret mode) and
    the port carrying the same params, on one seeded image with a padded
    mask: neck features, encoder memory, class logits and decoder states
    1e-4 relative, scores 2e-4, boxes 0.1 px set-wise."""
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((1, h, w, 3)).astype(np.float32)
    masks = np.zeros((1, h, w), np.float32)
    masks[:, int(h * 0.75):, :] = 1.0
    masks[:, :, int(w * 0.875):] = 1.0

    model = JaxCoDETR(cfg=jax_cfg, msda_impl="auto")

    def run(m, x, mk):
        feats = m.features(x)
        _, _, aux = m.query_head._run_transformer(feats, mk)
        return feats, aux, m.detect(feats, mk)

    (j_feats, j_aux, (j_boxes, j_scores, j_labels)), state = jax.jit(
        lambda p, x, mk: model.apply(
            p, x, mk, method=run, mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "encoder_layers",
        )
    )(params, jnp.asarray(img), jnp.asarray(masks))
    # per-layer encoder outputs (n_layers, bs, K, C); the last one is the memory
    j_memory = state["intermediates"]["query_head"]["transformer"]["encoder_layers"]["__call__"][0][0][-1]

    port = port_from_jax(params, port_cfg)
    with torch.no_grad():
        x, mk = torch.from_numpy(img), torch.from_numpy(masks)
        t_feats = port.features(x)
        _, _, t_aux = port.query_head.run_transformer(t_feats, mk)
        t_boxes, t_scores, t_labels = port.detect(t_feats, mk)

    for lvl, (tf, jf) in enumerate(zip(t_feats, j_feats)):
        err = rel_err(tf.numpy().transpose(0, 2, 3, 1), jf)
        assert err < 1e-4, f"neck level {lvl}: rel err {err:.2e}"
    assert rel_err(t_aux["memory"].numpy(), j_memory) < 1e-4
    assert rel_err(t_aux["enc_class"].numpy(), j_aux["enc_class"]) < 1e-4
    assert rel_err(t_aux["inter_states"].numpy(), j_aux["inter_states"]) < 1e-4
    assert rel_err(t_aux["inter_refs_unact"].numpy(), j_aux["inter_refs_unact"]) < 1e-4

    s_err = np.abs(t_scores.numpy() - np.asarray(j_scores)).max()
    assert s_err < 2e-4, f"scores err {s_err:.2e}"
    unmatched = match_detections(t_boxes.numpy()[0], t_labels.numpy()[0],
                                 np.asarray(j_boxes)[0], np.asarray(j_labels)[0], box_tol=0.1)
    assert unmatched <= max(1, t_boxes.shape[1] // 100), f"{unmatched} detections unmatched"


def test_tiny_slice_matches_jax(jax_params):
    assert_model_matches_jax(jax_tiny_test_config(), tiny_test_config(), jax_params, H, W)


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


def test_weight_round_trip_tiny_is_exact(jax_params):
    sd = state_dict_from_jax(jax_params, tiny_test_config())
    _assert_trees_equal(convert_state_dict(sd, jax_tiny_test_config()), jax_params)
    # and the carried dict is exactly the port's own key schema
    assert sorted(sd) == sorted(CoDETR(tiny_test_config()).state_dict())


def assert_key_schema_round_trip(port_cfg, jax_cfg):
    """Shapes only on the JAX side: the port's seeded state dict through
    convert_state_dict has exactly the JAX model's param shapes (traced at
    256x256, which gives the 900 proposals enough keys), and
    state_dict_from_jax inverts it."""
    port_sd = {k: v.numpy() for k, v in init_weights(CoDETR(port_cfg), seed=0).state_dict().items()}
    params = convert_state_dict(port_sd, jax_cfg)
    model = JaxCoDETR(cfg=jax_cfg, msda_impl="reference")
    want = jax.eval_shape(
        model.init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, 256, 256, 3), jnp.float32),
        jax.ShapeDtypeStruct((1, 256, 256), jnp.float32),
    )
    _assert_trees_equal(
        jax.tree.map(lambda a: np.asarray(a.shape), params),
        jax.tree.map(lambda a: np.asarray(a.shape), want),
    )
    back = state_dict_from_jax(params, port_cfg)
    assert sorted(back) == sorted(port_sd)
    for k, v in port_sd.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_swin_l_key_schema_round_trip():
    """Swin-L schema (no Swin-L forward runs on the CPU)."""
    assert_key_schema_round_trip(co_dino_swin_l(), jax_co_dino_swin_l())


def test_build_codetr_defaults_to_cuda_and_raises_without_a_card():
    """So do ``preprocess`` and the ``Inferencer``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_codetr(tiny_test_config())
    model = build_codetr(tiny_test_config(), device="cpu")
    assert next(model.parameters()).device.type == "cpu"
    image = np.zeros((20, 30, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess(image, 32, 32)
    assert preprocess(image, 32, 32, device="cpu")[0].device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        Inferencer(model, height=32, width=32)


FORBIDDEN = ("jax", "jaxlib", "flax", "codetr_tpu", "cv2")
# OpenCV draws detections, and the machine with the card has none: the one
# module that uses it imports it inside the function that draws, so the
# port imports, serves and exports without it
LAZY_CV2 = {"codetr_torch/utils/visualize.py"}


def _imports(path: Path):
    """(module, imported inside a function or class) for every import."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = {id(n) for n in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) not in top) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module, id(node) not in top


@pytest.mark.parametrize(
    "path",
    sorted((REPO / "codetr_torch").rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: os.path.relpath(p, REPO),
)
def test_port_imports_no_jax_or_cv2(path):
    lazy_cv2_ok = os.path.relpath(path, REPO) in LAZY_CV2
    bad = [m for m, nested in _imports(path)
           if m.split(".")[0] in FORBIDDEN and not (m == "cv2" and nested and lazy_cv2_ok)]
    assert not bad, f"{path} imports {bad}"


def test_bricks_match_jax():
    """The small helpers the model is built from, on seeded inputs."""
    from codetr_tpu.config import PositionalEncodingConfig as JaxPE
    from codetr_tpu.models import layers as jl
    from codetr_tpu.models import positional_encoding as jpe
    from codetr_torch.config import PositionalEncodingConfig
    from codetr_torch.models import layers as tl
    from codetr_torch.models import positional_encoding as tpe

    rng = np.random.default_rng(9)
    p = rng.uniform(-0.2, 1.2, (3, 50)).astype(np.float32)
    np.testing.assert_allclose(tl.inverse_sigmoid(torch.from_numpy(p)).numpy(),
                               np.asarray(jl.inverse_sigmoid(jnp.asarray(p))), rtol=1e-6, atol=1e-6)
    mask = (rng.random((2, 23, 37)) < 0.3).astype(np.float32)
    np.testing.assert_array_equal(tl.nearest_resize_mask(torch.from_numpy(mask), 6, 10).numpy(),
                                  np.asarray(jl.nearest_resize_mask(jnp.asarray(mask), 6, 10)))
    x = rng.standard_normal((1, 9, 14, 3)).astype(np.float32)
    np.testing.assert_array_equal(tl.corner_pad_to_multiple(torch.from_numpy(x), 4, 4).numpy(),
                                  np.asarray(jl.corner_pad_to_multiple(jnp.asarray(x), 4, 4)))
    m = mask > 0
    np.testing.assert_allclose(
        tpe.sine_positional_encoding(torch.from_numpy(m), PositionalEncodingConfig(num_feats=16)).numpy(),
        np.asarray(jpe.sine_positional_encoding(jnp.asarray(m), JaxPE(num_feats=16))), rtol=1e-5, atol=1e-5)
    boxes = rng.uniform(0, 1, (2, 7, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tpe.gen_sineembed_for_position(torch.from_numpy(boxes), 16).numpy(),
        np.asarray(jpe.gen_sineembed_for_position(jnp.asarray(boxes), 16)), rtol=1e-5, atol=1e-5)
