"""Run an AOTInductor package of the exported forward with its MSDA ops
registered from C++: no Python kernel code in the process.

    python codetr_torch/tools/aoti_run.py --package out/codetr.aoti.pt2 \\
        --ops-lib codetr_torch/_build/msda_ops-<hash>.so \\
        --inputs in.npz --outputs out.npz

Run it as a file, not with ``-m``: it imports torch and numpy and nothing
of ``codetr_torch``, so no Python registration of the ``codetr::`` ops
exists in its process.  It loads ``--ops-lib`` (``csrc/msda_ops.cpp`` with
``csrc/msda_fwd.cu``, built by ``codetr_torch.ops._build.build_ops()``)
with ``torch.ops.load_library``, the package (``runtime/aot.py:
save_package``) with ``torch._inductor.aoti_load_package``, runs it once on
the arrays ``arg0``, ``arg1``, ... of ``--inputs`` on the card, each cast to
its ``in_avals`` dtype (a bf16 package's image: an ``.npz`` holds no bf16),
an fp32 package (the meta's ``dtype``) with TF32 off as ``runtime/aot.py:
load_package`` runs it, and writes ``out0``, ``out1``, ... to
``--outputs`` (a bf16 output as float32, which holds it exactly).  It prints one JSON line: the dispatcher's registrations of
the two ops (the CUDA kernel's names ``msda_ops.cpp``), the seconds to
load and to run, and the modules of ``codetr_torch`` imported (none).  Any
failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

OPS = ("codetr::msda_packed", "codetr::msda_reference")
MAGIC = "codetr-torch-aoti-v1"  # runtime/aot.py:PACKAGE_MAGIC


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Run a codetr AOTInductor package with the C++ MSDA ops")
    ap.add_argument("--package", required=True, help="<name>.aoti.pt2 (its .meta.json beside it)")
    ap.add_argument("--ops-lib", required=True, help="the built csrc/msda_ops.cpp library")
    ap.add_argument("--inputs", required=True, help=".npz with arg0, arg1, ...")
    ap.add_argument("--outputs", required=True, help=".npz to write out0, out1, ... to")
    ap.add_argument("--device", default="cuda:0")
    return ap.parse_args(argv)


def codetr_modules() -> list:
    return sorted(m for m in sys.modules if m == "codetr_torch" or m.startswith("codetr_torch."))


def main(argv=None) -> dict:
    args = parse_args(argv)
    if codetr_modules():
        raise RuntimeError(f"codetr_torch is imported ({codetr_modules()}): its Python ops would collide")
    with open(args.package + ".meta.json") as f:
        meta = json.load(f)
    if meta.get("magic") != MAGIC:
        raise ValueError(f"{args.package}: magic {meta.get('magic')!r}, expected {MAGIC!r}")
    device = torch.device(args.device)
    if meta.get("device") != device.type:
        raise ValueError(f"{args.package} was compiled for {meta.get('device')!r}, not {device.type!r}")
    if meta["dtype"] == "float32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    torch.ops.load_library(args.ops_lib)
    registrations = {op: torch._C._dispatch_dump(op) for op in OPS}
    from torch._inductor import aoti_load_package

    compiled = aoti_load_package(args.package, device_index=device.index or 0)
    load_s = time.perf_counter() - t0

    dtypes = [getattr(torch, aval[1]) for aval in meta["in_avals"]]
    with np.load(args.inputs) as npz:
        if len(npz.files) != len(dtypes):
            raise ValueError(f"{args.inputs} holds {len(npz.files)} arrays, the package takes {len(dtypes)}")
        inputs = [torch.from_numpy(npz[f"arg{i}"]).to(device, dt) for i, dt in enumerate(dtypes)]
    t0 = time.perf_counter()
    with torch.no_grad():
        outputs = compiled(*inputs)
    torch.cuda.synchronize(device)
    run_s = time.perf_counter() - t0
    np.savez(args.outputs, **{f"out{i}": (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
                              for i, t in enumerate(outputs)})
    record = {"registrations": registrations, "load_s": load_s, "run_s": run_s, "dtype": meta["dtype"],
              "codetr_torch_modules": codetr_modules(), "outputs": len(outputs)}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
