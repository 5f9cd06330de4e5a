"""Build and load the port's CUDA kernels.

Each ``codetr_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library that is loaded with
``ctypes``.  The library is built at first use into ``codetr_torch/_build/``
(listed in ``.gitignore``) under a name keyed by the hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt
and an unchanged one is reused.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# No -lcuda: the one driver call (K5's cuTensorMapEncodeTiled) is reached
# through the runtime's cudaGetDriverEntryPoint.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class Built:
    """A loaded kernel library and how it was built."""

    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str  # nvcc's output, including ``-Xptxas -v``'s register report


_loaded: dict[str, Built] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises if the toolkit is absent."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built from "
            "source at first use"
        )
    return found


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _loaded:
        return _loaded[name]
    src = SRC_DIR / f"{name}.cu"
    # the shared headers too: a source that includes an edited one is rebuilt
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    log_path = so.with_suffix(".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src}:\n{proc.stdout}{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    built = Built(
        lib=ctypes.CDLL(str(so)),
        path=so,
        build_seconds=seconds,
        log=log_path.read_text() if log_path.exists() else "",
    )
    _loaded[name] = built
    return built
