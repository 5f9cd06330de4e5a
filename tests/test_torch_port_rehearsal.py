"""The checkpoint rehearsal (``codetr_torch/tools/rehearsal.py``) against the
JAX package's ``tools/rehearsal.py`` and its model, on the tiny config at
128x128 in fp32 on the CPU.

- ``perturb_offsets`` equals the JAX tool's bit for bit, and both refuse a
  state dict with no sampling-offset keys;
- the rehearsal's own ``.pth`` and images through the JAX ``build_codetr``
  (K1 in interpret mode) and through the port's reader agree on the ladder
  (scores 2e-4, boxes 0.1 px set-wise): the whole checkpoint-day chain
  against the JAX package;
- ``python -m codetr_torch.tools.rehearsal`` prints one record with the
  documented keys: mAP 1 and every box matched at IoU 1 (the reader on the
  CPU is the writer's function), ``pass``, a reader seed that is not the
  writer's, the meta's numpy values read back;
- ``--pth`` reads the given file and writes none;
- the staged share covers every encoder layer and equals
  ``msda_tiles.staged_share`` over the taps ``capture_encoder_taps``
  captures, and the capture restores the module after an error.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import build_codetr as jax_build_codetr
from codetr_torch.config import tiny_test_config
from codetr_torch.models import msda_module
from codetr_torch.models.codetr import build_codetr
from codetr_torch.ops import msda, msda_tiles
from codetr_torch.tools import rehearsal

from test_torch_port_model import match_detections

REPO = Path(__file__).resolve().parent.parent
HW = 128
TINY = ["--config", "tiny", "--device", "cpu", "--dtype", "float32", "--height", str(HW), "--width", str(HW)]
# what the JAX script sets with os.environ.setdefault when it is imported
JAX_TOOL_ENV = ("TPU_ACCELERATOR_TYPE", "TPU_WORKER_HOSTNAMES", "JAX_COMPILATION_CACHE_DIR")
RECORD_KEYS = {"height", "width", "offset_scale", "config", "device", "dtype", "images", "writer_seed",
               "reader_seed", "pth", "pth_written", "synthesize_s", "convert_s", "dataset_meta",
               "meta_numbers", "staged_share", "calibrate_s", "tier", "ap_vs_writer", "box_match_iou_p50",
               "box_match_iou_min", "proposals_shared", "proposals_in_place",
               "msda_launches", "serve_s", "latency_ms", "pass"}


def load_jax_rehearsal(monkeypatch):
    """The JAX ``tools/rehearsal.py`` as a module; its import-time
    environment defaults and ``sys.path`` entries are undone after the
    test."""
    for k in JAX_TOOL_ENV:
        absent = k not in os.environ
        monkeypatch.setenv(k, os.environ.get(k, ""))  # records the value (or its absence) to restore
        if absent:
            monkeypatch.delenv(k)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec = importlib.util.spec_from_file_location("jax_rehearsal", REPO / "tools" / "rehearsal.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def tiny_state_dict(seed):
    model = build_codetr(tiny_test_config(), device="cpu", seed=seed)
    return {k: v.numpy().copy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("scale,seed", [(1.0, 0), (1.5, 5), (0.5, 7)])
def test_perturb_offsets_matches_jax_bit_for_bit(scale, seed, monkeypatch):
    jax_tool = load_jax_rehearsal(monkeypatch)
    sd = tiny_state_dict(seed)
    got = rehearsal.perturb_offsets(dict(sd), scale, seed)
    want = jax_tool.perturb_offsets(dict(sd), scale, seed)
    assert list(got) == list(want) == list(sd)
    moved = 0
    for k in sd:
        assert got[k].dtype == want[k].dtype == sd[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        moved += not np.array_equal(got[k], sd[k])
    keys = [k for k in sd if "sampling_offsets" in k]
    # every encoder and decoder offset projection, weight and bias, and nothing else
    assert moved == len(keys) == 2 * 2 * 2


def test_perturb_offsets_refuses_a_dict_without_offsets(monkeypatch):
    jax_tool = load_jax_rehearsal(monkeypatch)
    sd = {"neck.convs.0.conv.weight": np.zeros((2, 2), np.float32)}
    with pytest.raises(AssertionError):
        jax_tool.perturb_offsets(dict(sd), 1.0, 0)
    with pytest.raises(AssertionError):
        rehearsal.perturb_offsets(dict(sd), 1.0, 0)


@pytest.fixture(scope="module")
def rehearsed(tmp_path_factory):
    """The tiny CPU command run as a user runs it -> (record, its .pth)."""
    pth = tmp_path_factory.mktemp("rehearsal") / "ckpt.pth"
    out = subprocess.run([sys.executable, "-m", "codetr_torch.tools.rehearsal", *TINY, "--out", str(pth)],
                         cwd=REPO, capture_output=True, text=True, timeout=300, check=True)
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0]), str(pth)


def test_cli_record(rehearsed):
    record, pth = rehearsed
    assert set(record) == RECORD_KEYS
    assert record["pth"] == pth and record["pth_written"] and os.path.exists(pth)
    assert abs(record["ap_vs_writer"]["mAP"] - 1) <= 1e-9
    assert abs(record["box_match_iou_min"] - 1) <= 1e-6
    assert record["pass"] is True
    assert record["reader_seed"] != record["writer_seed"]
    assert record["proposals_shared"] == record["proposals_in_place"] == [1.0] * record["images"]
    assert record["tier"] == "n/a: exact kernel" and record["latency_ms"] is None
    assert record["dataset_meta"]["classes"] == [f"obj{i}" for i in range(7)]
    assert record["meta_numbers"] == {"epoch": {"type": "int64", "value": rehearsal.EPOCH},
                                      "seed": {"type": "int64", "value": 0}}


def test_rehearsal_pth_serves_like_jax(rehearsed):
    """The rehearsal's ``.pth`` and images: the JAX package's model built
    from the file and the port's reader agree (scores 2e-4, boxes 0.1 px
    set-wise), image by image."""
    record, pth = rehearsed
    _, images = rehearsal.draw_inputs(record["writer_seed"], HW, HW, record["images"])
    model, params = jax_build_codetr(jax_tiny_test_config(), pth, msda_impl="auto", input_shape=(HW, HW))
    reader = build_codetr(tiny_test_config(), pth, device="cpu", seed=record["reader_seed"])
    port = rehearsal.detections(reader, images, torch.device("cpu"))
    forward = jax.jit(model.apply)
    for im, (tb, ts, tl, _) in zip(images, port):
        jb, js, jl = (np.asarray(a)[0] for a in forward(params, jnp.asarray(im[None]),
                                                          jnp.zeros((1, HW, HW), jnp.float32)))
        assert np.abs(ts - js).max() < 2e-4
        assert match_detections(tb, tl, jb, jl, box_tol=0.1) <= max(1, len(tb) // 100)


def test_given_pth_is_read_and_nothing_written(rehearsed, tmp_path):
    """``--pth``: the writer too is built from the file (another init seed
    changes nothing), and ``--out`` is not written."""
    _, pth = rehearsed
    mtime = os.stat(pth).st_mtime_ns
    never = tmp_path / "never.pth"
    record = rehearsal.main([*TINY, "--pth", pth, "--out", str(never), "--seed", "3"])
    assert record["pth"] == pth and not record["pth_written"]
    assert not never.exists() and os.stat(pth).st_mtime_ns == mtime
    assert record["pass"] and abs(record["ap_vs_writer"]["mAP"] - 1) <= 1e-9


def test_staged_share_covers_every_encoder_layer(rehearsed):
    record, pth = rehearsed
    cfg = tiny_test_config()
    cal_x, _ = rehearsal.draw_inputs(record["writer_seed"], HW, HW, record["images"])
    reader = build_codetr(cfg, pth, device="cpu", seed=record["reader_seed"])
    with rehearsal.capture_encoder_taps(keep=99) as calls:
        rehearsal.detections(reader, list(cal_x), torch.device("cpu"))
    n_layers = cfg.head.transformer.num_encoder_layers
    assert len(calls) == len(record["staged_share"]["per_layer"]) == n_layers
    served = total = 0
    for call, share in zip(calls, record["staged_share"]["per_layer"]):
        value, shapes, cpk, points = call["taps"]
        plan = msda_tiles.encoder_tile_plan(shapes, value.dtype, head_dim=value.shape[3], points=points)
        s, t = msda_tiles.staged_share(plan, *msda._unpack(cpk, value.shape[2], len(shapes), points))
        assert (s, t) == tuple(call["share"]) and s / t == share and t > 0
        served, total = served + s, total + t
    assert record["staged_share"]["corner_reads"] == [served, total]
    assert record["staged_share"]["overall"] == served / total


def test_capture_restores_the_module_after_an_error():
    packed = msda_module.msda_grid_packed
    with pytest.raises(ZeroDivisionError):
        with rehearsal.capture_encoder_taps():
            assert msda_module.msda_grid_packed is not packed
            1 / 0
    assert msda_module.msda_grid_packed is packed
