"""The port's R50 Co-DINO family against the JAX package: a narrow R50
model end to end, the weight carry between the two, the full-width key
schema and the config-file loader.

The narrow model is ``ResNetConfig(depth=50, stem_channels=8,
base_channels=8)`` (full depth, widths 32..256) under the tiny head, at
96x96 with a padded mask (the smallest input whose last level keeps more
than one value per GroupNorm group).  The JAX side builds its own params,
perturbed by seeded noise (frozen BatchNorm's mean and var too), and
``state_dict_from_jax`` carries them into the port.  Tolerances are the
JAX suite's ladder: features and states 1e-4 relative, scores 2e-4, boxes
0.1 px matched set-wise.
"""

import dataclasses
import os

import numpy as np
import pytest

from codetr_tpu.config import NeckConfig as JaxNeckConfig
from codetr_tpu.config import ResNetConfig as JaxResNetConfig
from codetr_tpu.config import co_dino_r50 as jax_co_dino_r50
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.utils.checkpoint import convert_state_dict
from codetr_tpu.utils.config_loader import load_config_file as jax_load_config_file
from codetr_torch.config import NeckConfig, ResNetConfig, co_dino_r50, co_dino_swin_l, tiny_test_config
from codetr_torch.models.codetr import CoDETR
from codetr_torch.utils.checkpoint import state_dict_from_jax
from codetr_torch.utils.config_loader import load_config_file

from test_torch_port_model import (
    REPO,
    _assert_trees_equal,
    assert_key_schema_round_trip,
    assert_model_matches_jax,
    perturbed_jax_params,
)

H = W = 96
WIDTHS = (32, 64, 128, 256)


def narrow_r50_configs():
    """(JAX config, port config) of the narrow R50 under the tiny head."""
    jax_cfg = jax_tiny_test_config().replace(
        backbone_type="resnet", swin=None,
        resnet=JaxResNetConfig(depth=50, stem_channels=8, base_channels=8),
        neck=JaxNeckConfig(in_channels=WIDTHS, out_channels=32, num_outs=5),
    )
    port_cfg = dataclasses.replace(
        tiny_test_config(), backbone_type="resnet", swin=None,
        resnet=ResNetConfig(depth=50, stem_channels=8, base_channels=8),
        neck=NeckConfig(in_channels=WIDTHS, out_channels=32, num_outs=5),
    )
    return jax_cfg, port_cfg


@pytest.fixture(scope="module")
def r50_params():
    return perturbed_jax_params(seed=2, cfg=narrow_r50_configs()[0], input_shape=(H, W))


def test_narrow_r50_matches_jax(r50_params):
    jax_cfg, port_cfg = narrow_r50_configs()
    assert port_cfg.resnet.num_features == WIDTHS
    assert_model_matches_jax(jax_cfg, port_cfg, r50_params, H, W, seed=3)


def test_narrow_r50_weight_round_trip_is_exact(r50_params):
    jax_cfg, port_cfg = narrow_r50_configs()
    sd = state_dict_from_jax(r50_params, port_cfg)
    _assert_trees_equal(convert_state_dict(sd, jax_cfg), r50_params)
    # the carried dict is exactly the port's own key schema
    assert sorted(sd) == sorted(CoDETR(port_cfg).state_dict())


def test_r50_key_schema_round_trip():
    """Full-width R50 (mmdet's keys: backbone.conv1, layer{s}.{b}.conv{j},
    downsample.0/1, the four frozen BatchNorm tensors)."""
    assert_key_schema_round_trip(co_dino_r50(), jax_co_dino_r50())
    keys = CoDETR(co_dino_r50()).state_dict()
    for k in ("backbone.conv1.weight", "backbone.bn1.running_var", "backbone.layer4.2.conv3.weight",
              "backbone.layer3.0.downsample.0.weight", "backbone.layer3.0.downsample.1.running_mean"):
        assert k in keys, k


def test_narrow_r50_train_step_matches_jax_and_keeps_bn_frozen(r50_params):
    """One train step of the narrow R50 in both packages from the carried
    weights, at 96x96 with a padded mask, the JAX side differentiating its
    exact MSDA oracle: the loss within 1e-5 relative and every gradient
    leaf that is not frozen BatchNorm within 1e-4 of its scale (the train
    tolerances of ``test_torch_port_train.py``).

    The frozen BatchNorm tensors are where the two packages part, and the
    port follows mmdet (``norm_eval``, frozen stages' BN never trained): the
    JAX ``FrozenBatchNorm`` declares scale, bias, mean and var as trainable
    ``params``, so its step moves them; the port holds them as buffers, so
    its step leaves them bit-identical."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
    from codetr_tpu.parallel import losses as jl
    from codetr_torch.parallel.train import adamw, make_train_step
    from test_torch_port_model import port_from_jax
    from test_torch_port_train import LR, assert_grads_match, rel

    jax_cfg, port_cfg = narrow_r50_configs()
    rng = np.random.default_rng(12)
    img = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    mask = np.zeros((1, H, W), np.float32)
    mask[:, int(H * 0.75):, :] = 1.0
    max_gt = 8
    boxes = np.concatenate([rng.uniform(0.2, 0.7, (1, max_gt, 2)), rng.uniform(0.05, 0.3, (1, max_gt, 2))],
                           -1).astype(np.float32)
    labels = rng.integers(0, jax_cfg.head.num_classes, (1, max_gt)).astype(np.int32)
    valid = np.arange(max_gt)[None] < 3
    boxes[~valid] = 0.0

    model = JaxCoDETR(cfg=jax_cfg, msda_impl="reference")
    tx = optax.adamw(LR)

    def loss_fn(p):
        out = model.apply(p, *(jnp.asarray(a) for a in (img, mask)), method=model.train_outputs)
        return jl.dino_detection_loss(out, *(jnp.asarray(a) for a in (boxes, labels, valid)))[0]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(r50_params)
    updates, _ = tx.update(grads, tx.init(r50_params), r50_params)
    moved = optax.apply_updates(r50_params, updates)

    port = port_from_jax(r50_params, port_cfg)
    buffers = {n: b.clone() for n, b in port.named_buffers()}
    port_loss = make_train_step(port, adamw(port, LR))(
        *(torch.from_numpy(a) for a in (img, mask, boxes)), torch.from_numpy(labels).long(),
        torch.from_numpy(valid)).item()
    assert rel(port_loss, loss) < 1e-5

    # the port's gradients on the flax paths; the buffers' leaves marked NaN
    sd = {n: p.grad.numpy() for n, p in port.named_parameters()}
    sd.update({n: np.full(b.shape, np.nan, np.float32) for n, b in buffers.items()})
    got = convert_state_dict(sd, jax_cfg)
    leaves = jax.tree_util.tree_leaves_with_path
    bn = {jax.tree_util.keystr(k) for k, v in leaves(got) if np.isnan(v).any()}
    assert len(bn) == len(buffers)  # each BN tensor is one flax leaf
    assert_grads_match(jax.tree.map(lambda a: np.nan_to_num(a, nan=0.0), got),
                       jax.tree.map(lambda a: np.asarray(a), grads), skip=bn)
    before, after = (dict((jax.tree_util.keystr(k), np.asarray(v)) for k, v in leaves(t))
                     for t in (r50_params, moved))
    assert all(not np.array_equal(before[k], after[k]) for k in bn)  # JAX moves every BN leaf
    for n, b in port.named_buffers():
        assert torch.equal(b, buffers[n]), n  # the port moves none


def _assert_kept_fields_equal(port, jax, path="cfg"):
    """Every field of the port's config dataclass equals the JAX one's."""
    if not dataclasses.is_dataclass(port):
        assert port == jax, f"{path}: {port!r} != {jax!r}"
        return
    for f in dataclasses.fields(port):
        _assert_kept_fields_equal(getattr(port, f.name), getattr(jax, f.name), f"{path}.{f.name}")


@pytest.mark.parametrize("name,preset", [
    ("co_dino_5scale_r50.py", co_dino_r50),
    ("co_dino_5scale_r50_lsj.py", co_dino_r50),
    ("co_dino_5scale_swin_l.py", co_dino_swin_l),
])
def test_config_loader_matches_jax(name, preset):
    path = os.path.join(REPO, "configs", name)
    got = load_config_file(path)
    _assert_kept_fields_equal(got, jax_load_config_file(path))
    assert got == preset()
