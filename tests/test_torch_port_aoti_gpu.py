"""The C++ registration of the MSDA ops (``csrc/msda_ops.cpp``) and an
AOTInductor package run with it, on the card.

``ops/_build.py:build_ops`` builds the library; a subprocess that imports
nothing of ``codetr_torch`` loads it and calls ``torch.ops.codetr.
msda_packed`` / ``msda_reference``, whose results must equal the Python
ops' CUDA launches in this process bit for bit (the same kernels, the same
plan).  A tiny package run through ``tools/aoti_run.py`` in a subprocess
must equal the same package run in this process.  Marked ``gpu``; this file
imports no JAX, so run it on the card without the suite's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_port_aoti_gpu.py
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from codetr_torch.ops import _build
from codetr_torch.ops import msda as port_msda

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
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    return proc.stdout


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
def test_tiny_package_runs_from_cpp(cuda_device, tmp_path):
    """A tiny fp32 package run by ``tools/aoti_run.py`` in a subprocess (the
    ops from C++, no codetr_torch module imported) equals the same package
    run in this process (the Python ops: 2 + 2 launches) bit for bit."""
    from codetr_torch import build_codetr, tiny_test_config
    from codetr_torch.runtime import aot

    built = _build.build_ops()
    model = build_codetr(tiny_test_config(), device=cuda_device, seed=4)
    fn, example = aot.compile_forward(model, height=96, width=96)
    path = aot.save_package(str(tmp_path / "tiny"), fn, example, meta={"config": "tiny"})
    package = aot.load_package(path)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((1, 96, 96, 3)).astype(np.float32))
    m = torch.zeros(1, 96, 96)
    m[:, 70:] = 1.0
    port_msda.launches = 0
    want = package(x.to(cuda_device), m.to(cuda_device))
    assert port_msda.launches == 4
    np.savez(tmp_path / "in.npz", arg0=x.numpy(), arg1=m.numpy())
    out = run([sys.executable, "-P", AOTI_RUN, "--package", path, "--ops-lib", str(built.path),
               "--inputs", str(tmp_path / "in.npz"), "--outputs", str(tmp_path / "out.npz")])
    record = json.loads(out.strip().splitlines()[-1])
    assert record["codetr_torch_modules"] == []
    for text in record["registrations"].values():
        assert "msda_ops.cpp" in [line for line in text.splitlines() if line.startswith("CUDA:")][0], text
    got = np.load(tmp_path / "out.npz")
    for i, t in enumerate(want):
        np.testing.assert_array_equal(got[f"out{i}"], t.cpu().numpy())
