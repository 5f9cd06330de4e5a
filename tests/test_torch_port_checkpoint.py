"""The port's mmdet ``.pth`` loading against the JAX package's.

Each ``.pth`` is written by the test itself: the torch oracle's tiny Swin
model with trained-like sampling offsets (the rehearsal's
``perturb_offsets``, held bit for bit against ``tools/rehearsal.py``'s by
``test_torch_port_rehearsal.py``) and a ``meta.dataset_meta``, and a narrow R50 whose BatchNorms carry
``num_batches_tracked``.  The port's ``load_torch_checkpoint`` must give,
key for key and bit for bit, ``state_dict_from_jax`` of the JAX
``load_torch_checkpoint``; ``swin_original_to_mmdet``,
``resize_bias_table`` and ``get_dataset_meta`` must equal the JAX
functions.  A file that lacks a key of the model raises ``KeyError`` in
both packages.
"""

import logging
import re

import numpy as np
import pytest
import torch

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.utils import checkpoint as jax_checkpoint
from codetr_torch.config import tiny_test_config
from codetr_torch.models.codetr import build_codetr
from codetr_torch.tools.rehearsal import perturb_offsets
from codetr_torch.utils import checkpoint
from codetr_torch.utils.checkpoint import state_dict_from_jax
from codetr_torch.utils.logging import get_logger

from test_torch_port_model import perturbed_jax_params
from test_torch_port_r50 import H as R50_HW
from test_torch_port_r50 import narrow_r50_configs
from torch_oracle import TorchCoDETR, init_oracle, oracle_state_dict_numpy


def save_pth(path, sd, wrapper="state_dict", meta=None, prefix=""):
    ckpt = {wrapper: {prefix + k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}}
    if meta is not None:
        ckpt["meta"] = meta
    torch.save(ckpt, path)
    return str(path)


@pytest.fixture(scope="module")
def swin_pth(tmp_path_factory):
    """The oracle's tiny Swin weights, offsets perturbed, under ``module.``
    with a ``meta.dataset_meta`` and keys of the training heads."""
    sd = oracle_state_dict_numpy(init_oracle(TorchCoDETR(jax_tiny_test_config()), seed=5))
    # the oracle registers each shifted block's attention twice (``._sw.``
    # aliases ``.attn.``); an mmdet checkpoint holds it once
    sd = perturb_offsets({k: v for k, v in sd.items() if "._sw." not in k}, 1.5, 5)
    rng = np.random.default_rng(6)
    sd["rpn_head.rpn_conv.weight"] = rng.standard_normal((4, 4)).astype(np.float32)
    sd["dn_query_generator.label_embedding.weight"] = rng.standard_normal((3, 4)).astype(np.float32)
    classes = [f"obj{i}" for i in range(7)]
    path = tmp_path_factory.mktemp("pth") / "swin.pth"
    return save_pth(path, sd, meta={"dataset_meta": {"CLASSES": classes}}, prefix="module."), sd


def assert_state_dicts_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_swin_pth_loads_like_jax(swin_pth):
    path, _ = swin_pth
    want = state_dict_from_jax(jax_checkpoint.load_torch_checkpoint(path, jax_tiny_test_config()),
                               tiny_test_config())
    got = checkpoint.load_torch_checkpoint(path, tiny_test_config())
    assert_state_dicts_equal(got, want)
    model = build_codetr(tiny_test_config(), path, device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)


def test_r50_pth_with_num_batches_tracked_loads_like_jax(tmp_path):
    jax_cfg, port_cfg = narrow_r50_configs()
    sd = state_dict_from_jax(perturbed_jax_params(seed=3, cfg=jax_cfg, input_shape=(R50_HW, R50_HW)),
                             port_cfg)
    bn = [k[:-len(".running_var")] for k in sd if k.endswith(".running_var")]
    assert bn
    for k in bn:
        sd[f"{k}.num_batches_tracked"] = np.asarray(7, np.int64)
    path = save_pth(tmp_path / "r50.pth", sd, wrapper="model")
    want = state_dict_from_jax(jax_checkpoint.load_torch_checkpoint(path, jax_cfg), port_cfg)
    got = checkpoint.load_torch_checkpoint(path, port_cfg)
    assert not any(k.endswith("num_batches_tracked") for k in got)
    assert_state_dicts_equal(got, want)


def test_load_report_names_the_unexpected_keys(swin_pth, tmp_path):
    _, sd = swin_pth
    sd = dict(sd, **{"query_head.extra_branch.weight": np.zeros((2, 2), np.float32)})
    path = save_pth(tmp_path / "extra.pth", sd)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = get_logger()
    logger.addHandler(handler)
    try:
        checkpoint.load_torch_checkpoint(path, tiny_test_config())
    finally:
        logger.removeHandler(handler)
    text = [r.getMessage() for r in records]
    assert any("loaded" in t and path in t for t in text)
    unexpected = [t for t in text if t.startswith("unexpected")]
    assert len(unexpected) == 1 and "query_head.extra_branch.weight" in unexpected[0], text
    assert "rpn_head" not in unexpected[0] and "dn_query" not in unexpected[0]


def original_swin_state_dict(rng, dims=8, depths=(2, 2)):
    """Seeded arrays under original-Swin-repo keys."""
    sd = {"patch_embed.proj.weight": rng.standard_normal((dims, 3, 4, 4)),
          "patch_embed.proj.bias": rng.standard_normal(dims),
          "patch_embed.norm.weight": rng.standard_normal(dims),
          "head.weight": rng.standard_normal((10, dims)),
          "norm0.weight": rng.standard_normal(dims)}
    c = dims
    for i, depth in enumerate(depths):
        for b in range(depth):
            key = f"layers.{i}.blocks.{b}"
            sd[f"{key}.attn.qkv.weight"] = rng.standard_normal((3 * c, c))
            sd[f"{key}.attn.relative_position_bias_table"] = rng.standard_normal((49, 2))
            sd[f"{key}.mlp.fc1.weight"] = rng.standard_normal((4 * c, c))
            sd[f"{key}.mlp.fc2.bias"] = rng.standard_normal(c)
            sd[f"{key}.norm1.weight"] = rng.standard_normal(c)
        if i < len(depths) - 1:
            sd[f"layers.{i}.downsample.reduction.weight"] = rng.standard_normal((2 * c, 4 * c))
            sd[f"layers.{i}.downsample.norm.weight"] = rng.standard_normal(4 * c)
            c *= 2
    return {k: v.astype(np.float32) for k, v in sd.items()}


def test_swin_original_to_mmdet_matches_jax():
    sd = original_swin_state_dict(np.random.default_rng(8))
    want = jax_checkpoint.swin_original_to_mmdet(sd)
    got = checkpoint.swin_original_to_mmdet(sd)
    assert_state_dicts_equal(got, want)
    assert "backbone.stages.0.downsample.reduction.weight" in got and not any("head." in k for k in got)


@pytest.mark.parametrize("old,new", [(7, 12), (12, 7), (4, 4), (7, 5)])
def test_resize_bias_table_matches_jax(old, new):
    table = np.random.default_rng(old * 13 + new).standard_normal(((2 * old - 1) ** 2, 3)).astype(np.float32)
    got = checkpoint.resize_bias_table(table, new, new)
    want = jax_checkpoint.resize_bias_table(table, new, new)
    assert got.shape == ((2 * new - 1) ** 2, 3)
    np.testing.assert_array_equal(got, want)


def test_window_size_change_resizes_the_tables(swin_pth, tmp_path):
    """A checkpoint trained at another window loads with its tables resized
    (bicubic), in both packages alike."""
    _, sd = swin_pth
    sd = dict(sd)
    for k in [k for k in sd if k.endswith("relative_position_bias_table")]:
        sd[k] = np.random.default_rng(len(k)).standard_normal((7 * 7, sd[k].shape[1])).astype(np.float32)
    path = save_pth(tmp_path / "win4.pth", sd)
    want = state_dict_from_jax(jax_checkpoint.load_torch_checkpoint(path, jax_tiny_test_config()),
                               tiny_test_config())
    got = checkpoint.load_torch_checkpoint(path, tiny_test_config())
    assert_state_dicts_equal(got, want)


@pytest.mark.parametrize("meta", [
    {"dataset_meta": {"CLASSES": ["a", "b"], "PALETTE": [[1, 2, 3]]}},
    {"CLASSES": ["c", "d", "e"]},
    {},
], ids=["dataset_meta", "CLASSES", "none"])
def test_get_dataset_meta_matches_jax(meta, tmp_path):
    path = str(tmp_path / "meta.pth")
    torch.save({"state_dict": {}, "meta": meta}, path)
    got = checkpoint.get_dataset_meta(path)
    want = jax_checkpoint.get_dataset_meta(path)
    assert {k: list(v) if isinstance(v, tuple) else v for k, v in got.items()} == \
        {k: list(v) if isinstance(v, tuple) else v for k, v in want.items()}


def numpy_meta(classes):
    """A training run's ``meta``: numpy scalars and arrays beside the
    dataset metadata."""
    return {"seed": np.int64(0), "arr": np.arange(3), "lr": np.float32(1e-4),
            "hist": np.zeros((2, 3), np.float16), "name": np.str_("run"),
            "dataset_meta": {"CLASSES": classes, "version": np.int64(2)}}


def test_pth_with_numpy_values_in_its_meta_loads_like_jax(swin_pth, tmp_path):
    """A ``.pth`` whose ``meta`` holds numpy scalars and arrays: the weights
    and ``dataset_meta`` equal the JAX package's (which reads with
    ``weights_only=False``), and the port still reads with
    ``weights_only=True``."""
    _, sd = swin_pth
    path = save_pth(tmp_path / "numpy_meta.pth", sd, meta=numpy_meta([f"obj{i}" for i in range(7)]))
    want = state_dict_from_jax(jax_checkpoint.load_torch_checkpoint(path, jax_tiny_test_config()),
                               tiny_test_config())
    assert_state_dicts_equal(checkpoint.load_torch_checkpoint(path, tiny_test_config()), want)
    model = build_codetr(tiny_test_config(), path, device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    got, want = checkpoint.get_dataset_meta(path), jax_checkpoint.get_dataset_meta(path)
    assert got == want and got["version"] == 2 and type(got["version"]) is np.int64


def test_numpy_1_module_names_load(tmp_path):
    """numpy 1 pickles its reconstructors as ``numpy.core.multiarray.*``,
    numpy 2 as ``numpy._core.multiarray.*``: a file naming either loads."""
    import io

    buf = io.BytesIO()
    meta = {"seed": np.int64(5), "arr": np.arange(4, dtype=np.int32)}
    torch.save({"state_dict": {}, "meta": meta}, buf, _use_new_zipfile_serialization=False)
    raw = buf.getvalue()
    names = (b"numpy._core.multiarray\n", b"numpy.core.multiarray\n")
    for old, new in (names, names[::-1]):
        path = tmp_path / f"{new.split(b'.')[1].decode()}.pth"
        path.write_bytes(raw.replace(old, new))
        assert new in path.read_bytes()
        got = checkpoint._read(str(path))["meta"]
        assert got["seed"] == 5 and type(got["seed"]) is np.int64
        np.testing.assert_array_equal(got["arr"], meta["arr"])
        assert got["arr"].dtype == np.int32


class Reduces:
    """Pickles as a call to ``fn(*args)``: what a malicious file does."""

    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("payload", ["os.system", "object array", "eval"])
def test_pth_naming_another_global_is_refused(payload, tmp_path):
    """Only numpy's reconstructors are let through: a ``.pth`` whose pickle
    names any other global (a ``__reduce__`` to ``os.system``, ``eval``) or
    holds an object array is refused by both readers, and nothing runs."""
    import builtins
    import os
    import pickle

    marker = tmp_path / "ran"
    value = {"os.system": Reduces(os.system, f"touch {marker}"),
             "object array": np.array([1, "a"], dtype=object),
             "eval": Reduces(builtins.eval, "1 + 1")}[payload]
    path = str(tmp_path / "evil.pth")
    torch.save({"state_dict": {}, "meta": {"x": value, "seed": np.int64(0)}}, path)
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.load_torch_checkpoint(path, tiny_test_config())
    with pytest.raises(pickle.UnpicklingError):
        checkpoint.get_dataset_meta(path)
    assert not marker.exists()


@pytest.mark.parametrize("key", [
    "query_head.transformer.decoder.layers.1.attentions.1.sampling_offsets.bias",
    "backbone.stages.1.blocks.0.attn.w_msa.qkv.weight",
], ids=["decoder_msda", "swin"])
def test_missing_key_raises_like_jax(key, tmp_path):
    """A ``.pth`` that lacks one key of the model: the JAX loader raises
    ``KeyError`` (its conversion reads every key), and so do the port's
    ``load_torch_checkpoint`` and ``build_codetr``, naming the key; the
    port no longer serves the key at its seeded init."""
    model = build_codetr(tiny_test_config(), device="cpu", seed=0)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert key in sd
    del sd[key]
    path = save_pth(tmp_path / "holed.pth", sd)
    with pytest.raises(KeyError, match=re.escape(key)):
        jax_checkpoint.load_torch_checkpoint(path, jax_tiny_test_config())
    with pytest.raises(KeyError, match=re.escape(key)):
        checkpoint.load_torch_checkpoint(path, tiny_test_config())
    with pytest.raises(KeyError, match=re.escape(key)):
        build_codetr(tiny_test_config(), path, device="cpu", seed=0)
