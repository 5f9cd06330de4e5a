"""Build and load the port's CUDA kernels.

Each ``codetr_torch/csrc/<name>.cu`` has a plain C interface and is compiled
by ``nvcc`` for Hopper (``sm_90a``) into a shared library that is loaded with
``ctypes``.  The library is built at first use into ``codetr_torch/_build/``
(listed in ``.gitignore``) under a name keyed by the hash of the source, the
shared ``csrc/*.cuh`` headers and the flags, so an edited source is rebuilt
and an unchanged one is reused.

``build_ops()`` builds the one library that includes PyTorch's headers:
``csrc/msda_ops.cpp`` (the ``codetr::`` MSDA forward ops registered from
C++) linked with ``csrc/msda_fwd.cu`` against libtorch.  It is built, never
loaded, here: a process loads it with ``torch.ops.load_library`` only if it
has not imported ``codetr_torch.ops.msda``, whose Python registrations of
the same schemas it would collide with (``tools/aoti_run.py``, the
runner).

``build_host()`` builds ``csrc/codetr_host.cpp`` (preprocess and NMS, a
plain C interface, ``utils/native.py``) with ``g++``, and
``build_runner(device)`` the native runner ``csrc/codetr_aoti_runner.cpp``,
a program linked against that library and libtorch; neither needs nvcc.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

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
    """A kernel library, loaded with ctypes (``build_ops``', ``build_host``'s
    and ``build_runner``'s: not loaded), and how it was built."""

    lib: Optional[ctypes.CDLL]
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    log: str  # the compiler's output (nvcc's with ``-Xptxas -v``'s register report)


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


def _library_path(name: str, sources, flags, suffix: str = ".so") -> Path:
    """``_build/<name>-<hash><suffix>``, keyed by the sources, the shared
    headers (a source that includes an edited one is rebuilt) and the
    flags."""
    headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    blob = b"".join(Path(s).read_bytes() for s in sources) + headers + " ".join(flags).encode()
    return BUILD_DIR / f"{name}-{hashlib.sha256(blob).hexdigest()[:16]}{suffix}"


def _run(cmd, what: str) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed to build {what}:\n{proc.stdout}{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(so: Path, make) -> tuple:
    """Run ``make(tmp)`` (-> its log) unless ``so`` exists; -> (seconds,
    log).  The library appears atomically: a concurrent loader sees all or
    nothing."""
    log_path = so.with_name(so.stem + ".log")
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        log = make(tmp)
        seconds = time.perf_counter() - t0
        log_path.write_text(log)
        os.replace(tmp, so)
    return seconds, log_path.read_text() if log_path.exists() else ""


def load(name: str) -> Built:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    if name in _loaded:
        return _loaded[name]
    src = SRC_DIR / f"{name}.cu"
    so = _library_path(name, [src], NVCC_FLAGS)
    seconds, log = _build(so, lambda tmp: _run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], str(src)))
    built = Built(lib=ctypes.CDLL(str(so)), path=so, build_seconds=seconds, log=log)
    _loaded[name] = built
    return built


OPS_NAME = "msda_ops"
OPS_SOURCES = ("msda_ops.cpp", "msda_fwd.cu")
# PyTorch's headers want C++20 from 2.10 on; the kernels keep NVCC_FLAGS
OPS_CXX_FLAGS = ("-std=c++20", "-O3", "-Xcompiler", "-fPIC")
OPS_LIBS = ("c10", "c10_cuda", "torch", "torch_cpu", "torch_cuda")


def _ops_flags():
    """(compile flags of msda_ops.cpp, link flags) against the running
    PyTorch's headers and libraries."""
    import torch
    from torch.utils import cpp_extension

    includes = [f"-I{p}" for p in cpp_extension.include_paths(device_type="cuda")]
    abi = f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}"
    # no rpath: the process that loads the library has imported torch, whose
    # libraries are then found by name
    link = [*(f"-L{d}" for d in cpp_extension.library_paths(device_type="cuda")),
            *(f"-l{lib}" for lib in OPS_LIBS)]
    return [*OPS_CXX_FLAGS, abi, *includes], link


def build_ops() -> Built:
    """Build (if needed) ``csrc/msda_ops.cpp`` with ``csrc/msda_fwd.cu`` into
    one library (``Built.lib`` is None: not loaded).  The two objects
    compile at once (the C++ one includes PyTorch's headers, the slow
    part), then nvcc links them against libtorch.  Keyed by the sources,
    the headers, the flags and PyTorch's version.  Raises if nvcc fails."""
    import torch

    if OPS_NAME in _loaded:
        return _loaded[OPS_NAME]
    cxx, link = _ops_flags()
    srcs = [SRC_DIR / s for s in OPS_SOURCES]
    so = _library_path(OPS_NAME, srcs, [*NVCC_FLAGS, *cxx, *link, torch.__version__])

    def make(tmp: Path) -> str:
        cpp, cu = srcs
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
        kernel_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        with ThreadPoolExecutor(2) as pool:
            logs = list(pool.map(lambda job: _run(*job), [
                ([nvcc(), *cxx, "-c", "-o", str(objs[0]), str(cpp)], str(cpp)),
                ([nvcc(), *kernel_flags, "-c", "-o", str(objs[1]), str(cu)], str(cu)),
            ]))
        logs.append(_run([nvcc(), "-shared", "-o", str(tmp), *map(str, objs), *link], f"{so.name} (link)"))
        for o in objs:
            o.unlink()
        return "".join(logs)

    seconds, log = _build(so, make)
    built = Built(lib=None, path=so, build_seconds=seconds, log=log)
    _loaded[OPS_NAME] = built
    return built


def gxx() -> str:
    """Path of the host C++ compiler; raises if there is none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host library and the runner are built from source at first use")
    return found


HOST_NAME = "codetr_host"
HOST_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")


def build_host() -> Built:
    """Build (if needed) ``csrc/codetr_host.cpp`` (``Built.lib`` is None:
    ``utils/native.py`` loads it).  Its soname is its file name, so the
    runner, linked against it, finds it beside itself.  Raises if g++
    fails."""
    if HOST_NAME in _loaded:
        return _loaded[HOST_NAME]
    src = SRC_DIR / f"{HOST_NAME}.cpp"
    so = _library_path(HOST_NAME, [src], HOST_FLAGS)
    seconds, log = _build(so, lambda tmp: _run(
        [gxx(), *HOST_FLAGS, f"-Wl,-soname,{so.name}", "-o", str(tmp), str(src)], str(src)))
    built = Built(lib=None, path=so, build_seconds=seconds, log=log)
    _loaded[HOST_NAME] = built
    return built


def _opencv_flags():
    """(compile flags, link flags) of OpenCV's image reading where
    ``pkg-config`` knows ``opencv4``; else none, and the runner takes raw
    RGB dumps only (``--image-height`` / ``--image-width``)."""
    pc = shutil.which("pkg-config")
    if pc is None:
        return [], []
    cflags = subprocess.run([pc, "--cflags", "opencv4"], capture_output=True, text=True)
    libdirs = subprocess.run([pc, "--libs-only-L", "opencv4"], capture_output=True, text=True)
    if cflags.returncode != 0 or libdirs.returncode != 0:
        return [], []
    return (["-DHAVE_OPENCV", *cflags.stdout.split()],
            [*libdirs.stdout.split(), "-lopencv_imgcodecs", "-lopencv_imgproc", "-lopencv_core"])


RUNNER_NAME = "codetr_aoti_runner"
RUNNER_LIBS = {"cpu": ("c10", "torch", "torch_cpu"),
               "cuda": ("c10", "torch", "torch_cpu", "c10_cuda", "torch_cuda")}


def build_runner(device: str = "cuda", opt: str = "-O2") -> Built:
    """Build (if needed) the native runner ``csrc/codetr_aoti_runner.cpp``
    for ``device`` ("cuda" or "cpu"): ``g++ -std=c++20`` with torch's headers
    and ABI flag, linked against ``build_host()``'s library and libtorch,
    with an rpath to both, so it runs with no ``LD_LIBRARY_PATH``; with
    OpenCV's image reading where ``pkg-config`` finds it.  The
    libraries are linked ``--no-as-needed``: the runner names no symbol of
    ``libtorch_cuda.so``, whose static initialisers register the CUDA
    backend and the CUDA AOTInductor model runner.  Nothing of Python is
    linked.  Keyed by the source, the flags, the host library and PyTorch's
    version.  Raises if g++ fails."""
    import torch
    from torch.utils import cpp_extension

    if device not in RUNNER_LIBS:
        raise ValueError(f"device must be one of {sorted(RUNNER_LIBS)}, got {device!r}")
    key = f"{RUNNER_NAME}-{device}{opt}"
    if key in _loaded:
        return _loaded[key]
    host = build_host()
    src = SRC_DIR / f"{RUNNER_NAME}.cpp"
    torch_lib = cpp_extension.library_paths()[0]
    cv_flags, cv_link = _opencv_flags()
    flags = ["-std=c++20", opt, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
             *(f"-I{p}" for p in cpp_extension.include_paths()), *cv_flags]
    link = [str(host.path), *cv_link, f"-L{torch_lib}",
            "-Wl,--no-as-needed", *(f"-l{lib}" for lib in RUNNER_LIBS[device]), "-Wl,--as-needed",
            "-ldl", f"-Wl,-rpath,{torch_lib}", "-Wl,-rpath,$ORIGIN"]
    exe = _library_path(f"{RUNNER_NAME}-{device}", [src], [*flags, *link, torch.__version__], suffix="")
    seconds, log = _build(exe, lambda tmp: _run([gxx(), *flags, "-o", str(tmp), str(src), *link], str(src)))
    built = Built(lib=None, path=exe, build_seconds=seconds, log=log)
    _loaded[key] = built
    return built
