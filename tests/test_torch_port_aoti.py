"""The exported forward as an AOTInductor package (``runtime/aot.py:
save_package`` / ``load_package``) against the JAX package, on the CPU.

One package compile in the whole suite: the tiny model at 96x96 with
weights carried from the JAX package (``perturbed_jax_params`` /
``port_from_jax``), compiled once for the CPU in a module fixture (about
80 s alone).  The package matches the JAX ``compile_forward`` set-wise at the
ladder (scores 2e-4, boxes 0.1 px) on seeded non-zero inputs (never the
all-zero example input, whose tied scores make top-k pick differently),
and the port's reloaded ``.codetr.pt2`` program the same way; an fp32
package runs with TF32 off and gives the caller's flags back.  The
exported graph's ``codetr::msda_packed`` nodes carry the tile plan that
``msda_tiles.encoder_tile_plan`` gives for their shapes; the schemas that
``csrc/msda_ops.cpp`` defines from C++ are the Python ops' text; a wrong
magic raises.  The C++ library, its ops against the Python ones and a
package run from C++ are ``tests/test_torch_port_aoti_gpu.py``'s (card).
"""

import json
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._inductor import config as inductor_config

from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.runtime.aot import compile_forward as jax_compile_forward
from codetr_torch.ops import msda as port_msda
from codetr_torch.ops import msda_tiles
from codetr_torch.runtime import aot

from test_torch_port_model import match_detections, perturbed_jax_params, port_from_jax
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

HW = 96
# the CPU compile without vectorised kernels, precompiled headers, an
# optimised wrapper or a pool of compile workers beside the suite's own:
# ~80 s instead of ~120 s alone, the same function (the card's packages
# compile with Inductor's defaults)
CHEAP_COMPILE = {"cpp.simdlen": 1, "aot_inductor.precompile_headers": False,
                 "aot_inductor.compile_wrapper_opt_level": "O0", "compile_threads": 1}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSDA_OPS = {"codetr.msda_packed.default": 2, "codetr.msda_reference.default": 2}
META = {"config": "tiny", "dtype": "float32", "height": HW, "width": HW, "batch_size": 1,
        "fused_preprocess": False}


@pytest.fixture(scope="module")
def params():
    return perturbed_jax_params(seed=3, input_shape=(HW, HW))


@pytest.fixture(scope="module")
def exported(params):
    return aot.compile_forward(port_from_jax(params), height=HW, width=HW)


@pytest.fixture(scope="module")
def saved(exported, tmp_path_factory):
    """The program saved and reloaded, and the package compiled once (the
    suite's one AOTInductor compile) and loaded, both on the CPU."""
    fn, example = exported
    tmp = tmp_path_factory.mktemp("aoti")
    exe = aot.save_executable(str(tmp / "tiny.codetr.pt2"), fn, example, meta=META)
    with inductor_config.patch(CHEAP_COMPILE):
        path = aot.save_package(str(tmp / "tiny"), fn, example, meta=META, device="cpu")
    return {"program": aot.load_executable(exe, device="cpu"), "path": path,
            "package": aot.load_package(path, device="cpu")}


@pytest.fixture(scope="module")
def jax_fn(params):
    return jax_compile_forward(JaxCoDETR(cfg=jax_tiny_test_config(), msda_impl="auto"), params,
                               height=HW, width=HW)[0]


def model_inputs(seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((1, HW, HW, 3)).astype(np.float32))
    m = torch.zeros(1, HW, HW)
    m[:, 70:] = 1.0
    m[:, :, 80:] = 1.0
    return x, m


def assert_on_the_ladder(got, want):
    """(boxes, scores, labels) of one image each: every detection matched
    set-wise (same label, boxes within 0.1 px), sorted scores within 2e-4."""
    g = [np.asarray(t[0]) for t in got]
    w = [np.asarray(t[0]) for t in want]
    assert match_detections(g[0], g[2], w[0], w[2], box_tol=0.1) == 0
    np.testing.assert_allclose(np.sort(g[1]), np.sort(w[1]), atol=2e-4, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_package_matches_jax_and_the_program(saved, jax_fn, seed):
    """The package on seeded inputs against the JAX ``compile_forward`` and
    against the port's reloaded ``.codetr.pt2`` program, at the ladder."""
    x, m = model_inputs(seed)
    got = [t.numpy() for t in saved["package"](x, m)]
    program = [t.numpy() for t in saved["program"](x, m)]
    assert [t.shape for t in got] == [t.shape for t in program]
    assert all(np.isfinite(t).all() for t in got)
    assert_on_the_ladder(got, [np.asarray(a) for a in jax_fn(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()))])
    assert_on_the_ladder(got, program)


def test_package_meta(saved):
    meta = json.loads(open(saved["path"] + ".meta.json").read())
    assert saved["path"].endswith(".aoti.pt2") and os.path.getsize(saved["path"]) > 0
    assert (meta["magic"], meta["device"], meta["dtype"]) == (aot.PACKAGE_MAGIC, "cpu", "float32")
    assert meta["in_avals"] == [[[1, HW, HW, 3], "float32"], [[1, HW, HW], "float32"]]
    assert meta["msda_ops"] == MSDA_OPS


@pytest.mark.parametrize("caller_flags", [(True, False), (True, True)])
def test_fp32_package_runs_without_tf32(saved, caller_flags, monkeypatch):
    """The package's GEMMs and convolutions read the TF32 flags as they run:
    an fp32 package runs under ``full_fp32`` (flags read where the package
    calls back into the encoder's MSDA op), and the caller's flags are back
    after the call."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    seen = []
    plain = port_msda.msda_grid_packed_plain

    def recording(*args, **kwargs):
        seen.append((cudnn.allow_tf32, matmul.allow_tf32))
        return plain(*args, **kwargs)

    monkeypatch.setattr(port_msda, "msda_grid_packed_plain", recording)
    kept = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = caller_flags
    try:
        saved["package"](*model_inputs(0))
        after = (cudnn.allow_tf32, matmul.allow_tf32)
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = kept
    assert seen == [(False, False)] * 2
    assert after == caller_flags


def test_exported_packed_nodes_carry_the_tile_plan(exported):
    """Each ``codetr::msda_packed`` node's ``plan`` is ``encoder_tile_plan``'s
    for its level shapes, value dtype, head dim and points, flattened as
    ``csrc/msda_ops.cpp`` splits it; the reference entry takes none."""
    fn, _ = exported
    assert aot.msda_nodes(fn.exported) == MSDA_OPS
    plans = []
    for node in fn.exported.graph.nodes:
        if node.op == "call_function" and str(node.target) == "codetr.msda_packed.default":
            value, _, flat, points, plan = node.args
            val = value.meta["val"]
            shapes = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
            want = msda_tiles.encoder_tile_plan(shapes, val.dtype, head_dim=val.shape[3], points=points)
            arrays = want.c_arrays()
            L = len(shapes)
            assert list(plan) == [*arrays["tile_h"], *arrays["tile_w"], *arrays["win_h"], *arrays["win_w"],
                                  *arrays["staged"], *arrays["off_b"], *arrays["off_acc"], want.halo,
                                  want.smem_bytes]
            assert len(plan) == 4 * L + 3 * L * L + 2
            plans.append(plan)
        elif node.op == "call_function" and str(node.target) == "codetr.msda_reference.default":
            assert len(node.args) == 4
    assert len(plans) == 2


def test_cpp_schemas_equal_the_python_ops():
    """``csrc/msda_ops.cpp`` defines the two schemas with the Python ops'
    text and registers a CUDA kernel for each (a file-text check; the
    library is built and run on the card)."""
    src = open(os.path.join(REPO, "codetr_torch", "csrc", "msda_ops.cpp")).read()
    defs = dict(re.findall(r'm\.def\("(\w+)(\(.*?\) -> Tensor)"\);', src))
    assert defs == {"msda_packed": port_msda._packed_op._schema,
                    "msda_reference": port_msda._reference_op._schema}
    assert defs["msda_packed"] == port_msda.PACKED_SCHEMA
    assert "TORCH_LIBRARY(codetr, m)" in src and "TORCH_LIBRARY_IMPL(codetr, CUDA, m)" in src
    assert sorted(re.findall(r'm\.impl\("(\w+)"', src)) == ["msda_packed", "msda_reference"]


def test_export_cli_takes_package_as_an_opt_in():
    """``--package`` (a compile of minutes) is off unless asked for."""
    from codetr_torch import export_aot

    assert export_aot.parse_args([]).package is False
    assert export_aot.parse_args(["--package", "--device", "cpu"]).package is True


def test_load_package_raises_on_a_wrong_magic(tmp_path):
    """A meta whose magic is not the package's (here the ``.codetr.pt2``
    program's) raises before any package is read."""
    path = str(tmp_path / "bad.aoti.pt2")
    with open(path + ".meta.json", "w") as f:
        json.dump({**META, "magic": aot.MAGIC, "device": "cpu"}, f)
    with pytest.raises(ValueError, match="magic"):
        aot.load_package(path, device="cpu")
