"""The C++ registration of the MSDA ops (``csrc/msda_ops.cpp``) and an
AOTInductor package run with it, on the card.

``ops/_build.py:build_ops`` builds the library; a subprocess that imports
nothing of ``codetr_torch`` loads it and calls ``torch.ops.codetr.
msda_packed`` / ``msda_reference``, whose results must equal the Python
ops' CUDA launches in this process bit for bit (the same kernels, the same
plan).  A tiny package (compiled once for the file in fp32 and once in bf16) run through
``tools/aoti_run.py`` in a subprocess, and by the native runner
(``csrc/codetr_aoti_runner.cpp``, ``_build.build_runner("cuda")``) on the
host library's preprocess of a raw image, must equal the same package run
in this process; the runner's ``--smoke`` finds both ops' CUDA kernels.
Marked ``gpu``; this file imports no JAX, so run it on the card without the
suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_aoti_gpu.py
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from codetr_torch.config import PreprocessConfig
from codetr_torch.ops import _build
from codetr_torch.ops import msda as port_msda
from codetr_torch.utils import native

from test_torch_port_cuda import SHAPES, kept_tf32_flags, make_inputs, pack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AOTI_RUN = os.path.join(REPO, "codetr_torch", "tools", "aoti_run.py")

# Calls the C++ ops on the arrays of argv[2] and writes their results to
# argv[3]; imports nothing of codetr_torch.
OPS_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.ops.load_library(sys.argv[1])
    a = np.load(sys.argv[2])
    out = {}
    for key in sorted(k[len("value_"):] for k in a.files if k.startswith("value_")):
        dtype = torch.bfloat16 if key.endswith("bf16") else torch.float32
        v = torch.from_numpy(a["value_" + key]).cuda().to(dtype)
        shapes = [int(s) for s in a["shapes_" + key]]
        if "cpk_" + key in a.files:
            r = torch.ops.codetr.msda_packed(v, torch.from_numpy(a["cpk_" + key]).cuda(), shapes,
                                             int(a["points_" + key]), [int(p) for p in a["plan_" + key]])
        else:
            r = torch.ops.codetr.msda_reference(v, torch.from_numpy(a["loc_" + key]).cuda(),
                                                torch.from_numpy(a["attn_" + key]).cuda(), shapes)
        out[key] = r.float().cpu().numpy()
    assert not [m for m in sys.modules if m.startswith("codetr_torch")]
    np.savez(sys.argv[3], **out)
    print(torch._C._dispatch_dump("codetr::msda_packed"))
""")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the op library and the package's kernels have no CPU mode")
    with kept_tf32_flags():
        yield torch.device("cuda")


def run(cmd, timeout=900):
    proc = subprocess.run([str(c) for c in cmd], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc.stdout


TINY_HW = 96


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def tiny_package(request, tmp_path_factory):
    """The tiny seed-4 model as a CUDA package at 96x96, fp32 and bf16 (the
    file's two package compiles) -> its path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the op library and the package's kernels have no CPU mode")
    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.runtime import aot

    with kept_tf32_flags():
        model = build_codetr(tiny_test_config(), device="cuda", seed=4, dtype=aot.DTYPES[request.param])
        fn, example = aot.compile_forward(model, height=TINY_HW, width=TINY_HW)
        path = aot.save_package(str(tmp_path_factory.mktemp("aoti") / "tiny"), fn, example,
                                meta={"config": "tiny"})
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    assert meta["dtype"] == request.param and meta["in_avals"][0] == [[1, TINY_HW, TINY_HW, 3], request.param]
    return path


@pytest.mark.gpu
def test_runner_smoke_finds_the_cpp_kernels(cuda_device):
    """``--smoke --device cuda`` with the op library: both ``codetr::`` ops
    have a CUDA kernel, registered by ``msda_ops.cpp``."""
    out = run([_build.build_runner("cuda").path, "--smoke", "--device", "cuda", "--ops-lib",
               _build.build_ops().path])
    lines = out.strip().splitlines()
    assert lines[-1] == "ok"
    for op in ("codetr::msda_packed", "codetr::msda_reference"):
        line = next(line for line in lines if line.startswith(op + ":"))
        assert "CUDA kernel yes" in line and "msda_ops.cpp" in line, out


@pytest.mark.gpu
def test_cpp_ops_equal_the_python_launches(cuda_device, tmp_path):
    """Both ops from C++ against the Python ops' CUDA launches on the same
    inputs, bit for bit: the packed entry with the plan ``msda_grid_packed``
    builds, at each of SHAPES, fp32 and bf16; the reference entry with 50
    box queries.  The library builds (``Built.log`` holds nvcc's output)."""
    built = _build.build_ops()
    assert built.path.exists() and built.lib is None
    arrays, want = {}, {}
    for i, shapes in enumerate(SHAPES):
        value, loc, w = make_inputs(np.random.default_rng(40 + i), shapes, h=8, d=32, P=4)
        _, loc_d, w_d = make_inputs(np.random.default_rng(50 + i), shapes, num_queries=50, h=8, d=32, P=4)
        flat = [int(v) for hw in shapes for v in hw]
        for dtype, tag in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
            v = torch.from_numpy(value).to(cuda_device, dtype)
            cpk = pack(loc, w)
            key = f"packed{i}_{tag}"
            arrays.update({f"value_{key}": v.float().cpu().numpy(), f"shapes_{key}": np.asarray(flat),
                           f"cpk_{key}": cpk, f"points_{key}": np.asarray(4),
                           f"plan_{key}": np.asarray(port_msda.packed_plan(shapes, dtype, 32, 4))})
            want[key] = port_msda.msda_grid_packed(v, shapes, torch.from_numpy(cpk).to(cuda_device), 4)
            key = f"reference{i}_{tag}"
            arrays.update({f"value_{key}": v.float().cpu().numpy(), f"shapes_{key}": np.asarray(flat),
                           f"loc_{key}": loc_d, f"attn_{key}": w_d})
            want[key] = port_msda.multi_scale_deformable_attention(
                v, shapes, torch.from_numpy(loc_d).to(cuda_device), torch.from_numpy(w_d).to(cuda_device))
    np.savez(tmp_path / "in.npz", **arrays)
    dump = run([sys.executable, "-P", "-c", OPS_SCRIPT, str(built.path), str(tmp_path / "in.npz"),
                str(tmp_path / "out.npz")])
    assert "msda_ops.cpp" in [line for line in dump.splitlines() if line.startswith("CUDA:")][0], dump
    got = np.load(tmp_path / "out.npz")
    assert sorted(got.files) == sorted(want)
    for key, t in want.items():
        np.testing.assert_array_equal(got[key], t.float().cpu().numpy(), err_msg=key)


@pytest.mark.gpu
def test_tiny_package_runs_from_cpp(cuda_device, tiny_package, tmp_path):
    """A tiny package, fp32 and bf16, run by ``tools/aoti_run.py`` in a
    subprocess (the ops from C++, no codetr_torch module imported; the
    image cast to the package's dtype there, the outputs read back as
    float32) equals the same package run in this process (the Python ops:
    2 + 2 launches) bit for bit."""
    from codetr_torch.runtime import aot

    built = _build.build_ops()
    package = aot.load_package(tiny_package)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 96, 96, 3)).astype(np.float32))
    m = torch.zeros(1, 96, 96)
    m[:, 70:] = 1.0
    port_msda.launches = 0
    want = package(x.to(cuda_device, package.dtype), m.to(cuda_device))
    assert port_msda.launches == 4
    np.savez(tmp_path / "in.npz", arg0=x.numpy(), arg1=m.numpy())
    out = run([sys.executable, "-P", AOTI_RUN, "--package", tiny_package, "--ops-lib", str(built.path),
               "--inputs", str(tmp_path / "in.npz"), "--outputs", str(tmp_path / "out.npz")])
    record = json.loads(out.strip().splitlines()[-1])
    assert record["codetr_torch_modules"] == []
    for text in record["registrations"].values():
        assert "msda_ops.cpp" in [line for line in text.splitlines() if line.startswith("CUDA:")][0], text
    got = np.load(tmp_path / "out.npz")
    assert record["dtype"] == {torch.float32: "float32", torch.bfloat16: "bfloat16"}[package.dtype]
    for i, t in enumerate(want):
        np.testing.assert_array_equal(got[f"out{i}"], (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy())


@pytest.mark.gpu
def test_runner_runs_the_tiny_package(cuda_device, tiny_package, tmp_path):
    """The native runner on a seeded 70x90 raw image, fp32 and bf16 (the
    runner casts the image to the package's dtype and reads the outputs
    back as float32): its dump equals the
    in-process package's outputs on ``preprocess_native`` of the image bit
    for bit, the op library counts 2 + 2 K1 launches a forward, and its NMS
    count is ``batched_nms_native``'s on the in-process outputs.  Without
    ``--ops-lib`` the package, which calls ``codetr::`` ops, is refused."""
    from codetr_torch.runtime import aot

    runner, ops = _build.build_runner("cuda"), _build.build_ops()
    image = np.random.default_rng(6).integers(0, 256, (70, 90, 3), np.uint8)
    image.tofile(tmp_path / "image.rgb")
    args = ["--model", tiny_package, "--device", "cuda", "--image", tmp_path / "image.rgb", "--image-height", 70,
            "--image-width", 90, "--iterations", 2, "--dump-raw", tmp_path / "raw"]
    out = run([runner.path, *args, "--ops-lib", ops.path])
    assert re.search(r"codetr::msda_packed 6, codetr::msda_reference 6 over 3 forwards", out), out
    cfg = PreprocessConfig()
    x, m, _, _ = native.preprocess_native(image, TINY_HW, TINY_HW, cfg.mean, cfg.std)
    package = aot.load_package(tiny_package)
    want = [t.float().cpu().numpy() for t in package(
        torch.from_numpy(x[None]).to(cuda_device, package.dtype), torch.from_numpy(m[None]).to(cuda_device))]
    for key, t in zip(("boxes", "scores", "labels"), want):
        np.testing.assert_array_equal(np.fromfile(tmp_path / f"raw.{key}.bin", np.float32), t.ravel(), err_msg=key)
    keep = native.batched_nms_native(want[0][0], want[1][0], want[2][0], 0.8, 0.0)
    assert int(re.search(r"detections after NMS: (\d+)", out).group(1)) == keep.sum()
    refused = subprocess.run([str(a) for a in (runner.path, *args)], capture_output=True, text=True, timeout=300)
    assert refused.returncode == 1 and "pass --ops-lib" in refused.stderr, refused.stderr
