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
