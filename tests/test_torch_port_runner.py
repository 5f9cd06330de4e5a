"""The native runner (``codetr_torch/csrc/codetr_aoti_runner.cpp``) and the
port's host library (``csrc/codetr_host.cpp`` through ``utils/native.py``)
on the CPU.

The host library's preprocess is held against the JAX package's numpy
preprocess and the port's torch one (resized size and scale equal, mask
equal, image within 2e-2: cv2 resizes in fixed point), its NMS against
``tests/test_nms.py``'s oracle per class.  The runner, built with ``-O0``
for the CPU by ``ops/_build.py:build_runner`` while the package compiles,
runs the tiny ``msda_impl="reference"`` model (seeded weights + noise
carried through the JAX ``convert_state_dict``, no JAX init compiled; no
``codetr::`` node, so no op library) compiled once as a
CPU AOTInductor package at 96x96 under ``CHEAP_COMPILE``, on a seeded
48x56 raw RGB dump: its raw outputs sit on the ladder against the
in-process ``load_package`` and the JAX ``compile_forward`` on the host
library's preprocess of the same image, its NMS count is
``batched_nms_native``'s on its own dump, and it refuses what it cannot run
with a non-zero exit.  The CUDA runner with the op library is
``tests/test_torch_port_aoti_gpu.py``'s (card).  Skips only where ``g++``
is missing.
"""

import json
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._inductor import config as inductor_config

from codetr_tpu.config import PreprocessConfig as JaxPreprocessConfig
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.runtime.aot import compile_forward as jax_compile_forward
from codetr_tpu.utils.preprocess import preprocess_numpy
from codetr_torch.config import PreprocessConfig
from codetr_torch.ops import _build
from codetr_torch.runtime import aot
from codetr_torch.utils import native
from codetr_torch.utils.preprocess import preprocess

from test_nms import np_nms, random_boxes
from test_torch_port_aoti import CHEAP_COMPILE, assert_on_the_ladder
from test_torch_port_model import port_from_jax
from test_torch_port_msda_impls import seeded_jax_params
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

HW = 96  # 64 leaves the neck's extra level 1x1, which GroupNorm refuses
IMAGE_HW = (48, 56)
META = {"config": "tiny", "dtype": "float32", "height": HW, "width": HW, "batch_size": 1,
        "fused_preprocess": False}
IOU, SCORE = 0.8, 0.0  # the runner's default thresholds


def require_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on the path: the host library and the runner are built from source")


@pytest.fixture(scope="module")
def runner_build():
    """The CPU runner's build, started at once in a thread (g++ runs beside
    the package's compile); ``.result()`` is the ``Built``."""
    require_gxx()
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_build.build_runner, "cpu", "-O0")


def run_runner(build, *args):
    return subprocess.run([str(build.result().path), *map(str, args)], capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("seed, image_hw, out_hw", [(0, (48, 96), (64, 64)), (1, (120, 90), (96, 128)),
                                                    (2, (37, 53), (64, 80))])
def test_host_library_matches_the_numpy_references(seed, image_hw, out_hw):
    """Preprocess against the JAX ``preprocess_numpy`` (cv2) and the port's
    ``preprocess`` on the CPU; per-class NMS against ``np_nms`` class by
    class; a score threshold drops exactly the kept boxes below it."""
    require_gxx()
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (*image_hw, 3), np.uint8)
    h, w = out_hw
    cfg = PreprocessConfig()
    out, mask, scale, resized = native.preprocess_native(img, h, w, cfg.mean, cfg.std)
    port = [t.numpy() if hasattr(t, "numpy") else t for t in preprocess(img, h, w, cfg, device="cpu")]
    for want in (preprocess_numpy(img, h, w, JaxPreprocessConfig()), port):
        assert resized == tuple(want[3])
        assert scale == pytest.approx(want[2])
        np.testing.assert_array_equal(mask, want[1])
        np.testing.assert_allclose(out, want[0], atol=2e-2, rtol=0)

    boxes = np.tile(random_boxes(rng, 32), (2, 1))
    scores = rng.uniform(0, 1, 64).astype(np.float32)
    labels = np.repeat(np.array([3, 7], np.int32), 32)
    keep = native.batched_nms_native(boxes, scores, labels, 0.5)
    np.testing.assert_array_equal(keep, np.concatenate([np_nms(boxes[:32], scores[:32], 0.5),
                                                        np_nms(boxes[32:], scores[32:], 0.5)]))
    cut = np.median(scores[keep])
    kept_above = native.batched_nms_native(boxes, scores, labels, 0.5, score_threshold=cut)
    np.testing.assert_array_equal(kept_above, keep & (scores >= cut))
    assert kept_above.sum() < keep.sum()


def test_host_library_is_the_ports_own():
    require_gxx()
    built = _build.build_host()
    assert built.path.parent == _build.BUILD_DIR and built.path.name.startswith("codetr_host-")
    assert native.load_host_library().codetr_host_version() == native.VERSION


@pytest.fixture(scope="module")
def params():
    return seeded_jax_params(seed=5)


@pytest.fixture(scope="module")
def package(params, runner_build, tmp_path_factory):
    """The tiny reference-impl model as a CPU package (the file's one
    AOTInductor compile), compiled while the runner builds."""
    fn, example = aot.compile_forward(port_from_jax(params, msda_impl="reference"), height=HW, width=HW)
    assert aot.msda_nodes(fn.exported) == {}
    with inductor_config.patch(CHEAP_COMPILE):
        return aot.save_package(str(tmp_path_factory.mktemp("runner") / "tiny_reference"), fn, example,
                                meta=META, device="cpu")


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(11).integers(0, 256, (*IMAGE_HW, 3), np.uint8)


def read_dump(prefix):
    boxes, scores, labels = (np.fromfile(f"{prefix}.{k}.bin", np.float32) for k in ("boxes", "scores", "labels"))
    return boxes.reshape(1, -1, 4), scores[None], labels[None]


@pytest.fixture(scope="module")
def runner_run(package, runner_build, image, tmp_path_factory):
    """The runner on the image's raw dump: (its stdout, its raw outputs)."""
    tmp = tmp_path_factory.mktemp("run")
    image.tofile(tmp / "image.rgb")
    proc = run_runner(runner_build, "--model", package, "--device", "cpu", "--image", tmp / "image.rgb",
                      "--image-height", IMAGE_HW[0], "--image-width", IMAGE_HW[1], "--iterations", 1,
                      "--dump-raw", tmp / "raw")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout, read_dump(tmp / "raw")


def test_runner_outputs_sit_on_the_ladder(runner_run, package, params, image):
    """Against the in-process package and the JAX reference-impl forward,
    both on the host library's preprocess of the same image."""
    stdout, got = runner_run
    assert stdout.strip().splitlines()[-1] == "ok"
    assert "preprocess: 56x48 -> resized 96x82" in stdout
    assert re.search(r"latency: [0-9.]+ ms/iter over 1 iters", stdout)
    cfg = PreprocessConfig()
    x, m, _, _ = native.preprocess_native(image, HW, HW, cfg.mean, cfg.std)
    x, m = x[None], m[None]
    in_process = [t.numpy() for t in aot.load_package(package, device="cpu")(torch.from_numpy(x),
                                                                              torch.from_numpy(m))]
    jax_fn = jax_compile_forward(JaxCoDETR(cfg=jax_tiny_test_config(), msda_impl="reference"), params,
                                 height=HW, width=HW)[0]
    jax_out = [np.asarray(a) for a in jax_fn(jnp.asarray(x), jnp.asarray(m))]
    assert [t.shape[1] for t in got] == [t.shape[1] for t in in_process]
    assert all(np.isfinite(t).all() for t in got)
    assert_on_the_ladder(got, in_process)
    assert_on_the_ladder(got, jax_out)


def test_runner_nms_count_is_batched_nms_native(runner_run):
    stdout, (boxes, scores, labels) = runner_run
    printed = int(re.search(r"detections after NMS: (\d+)", stdout).group(1))
    keep = native.batched_nms_native(boxes[0], scores[0], labels[0].astype(np.int32), IOU, SCORE)
    assert printed == keep.sum() > 0


def test_runner_reads_image_files_where_built_with_opencv(runner_run, package, runner_build, image, tmp_path):
    """With OpenCV (``pkg-config opencv4``) the runner reads a PNG as
    ``cv::imread`` + BGR to RGB and gives the raw dump's outputs bit for
    bit; without it, a file that is not a raw dump exits 2."""
    cv2.imwrite(str(tmp_path / "image.png"), image[..., ::-1])
    proc = run_runner(runner_build, "--model", package, "--device", "cpu", "--image", tmp_path / "image.png",
                      "--iterations", 1, "--dump-raw", tmp_path / "png")
    if not _build._opencv_flags()[0]:
        assert proc.returncode == 2 and "built without OpenCV" in proc.stderr
        return
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for a, b in zip(read_dump(tmp_path / "png"), runner_run[1]):
        np.testing.assert_array_equal(a, b)


def test_runner_smoke_on_the_cpu(runner_build):
    """``--smoke --device cpu``: libtorch loads, no ``codetr::`` op exists
    without the op library, and the preprocess constants are the port's
    ``PreprocessConfig``."""
    proc = run_runner(runner_build, "--smoke", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ok"
    assert "codetr::msda_packed: not registered" in lines and "codetr::msda_reference: not registered" in lines
    mean_std = next(line for line in lines if line.startswith("preprocess mean")).split()
    cfg = PreprocessConfig()
    np.testing.assert_allclose([float(v) for v in mean_std[2:5] + mean_std[6:9]], cfg.mean + cfg.std, rtol=1e-6)


GOOD_META = {**META, "magic": aot.PACKAGE_MAGIC, "device": "cpu", "msda_ops": {},
             "in_avals": [[[1, HW, HW, 3], "float32"], [[1, HW, HW], "float32"]]}
REFUSED = {
    "unknown flag": (2, "unknown argument", {}, ["--bogus"]),
    "meta for the card": (1, "was compiled for cuda, not cpu", {"device": "cuda"}, []),
    "wrong magic": (1, "magic", {"magic": "codetr-torch-pt2-v1"}, []),
    "codetr ops, no op library": (1, "pass --ops-lib", {"msda_ops": {"codetr.msda_packed.default": 2}}, []),
    "size off the package's": (1, "do not fit", {}, ["--height", HW + 32]),
    "a missing op library": (1, "dlopen", {}, ["--ops-lib", "missing_msda_ops.so"]),
    "a raw dump of another size": (2, "bytes, not", {}, ["--image", "{image}", "--image-height", 40,
                                                          "--image-width", 40]),
    "the card without one": (1, "no CUDA device", {}, ["--device", "cuda", "--smoke"]),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_runner_refuses_with_a_nonzero_exit(case, runner_build, tmp_path):
    """Each refusal prints a FATAL line and exits non-zero before any
    package is read (the metas here have no package beside them)."""
    code, message, meta_change, extra = REFUSED[case]
    model = tmp_path / "fake.aoti.pt2"
    (tmp_path / "fake.aoti.pt2.meta.json").write_text(json.dumps({**GOOD_META, **meta_change}))
    (tmp_path / "image.rgb").write_bytes(bytes(48 * 56 * 3))
    extra = [str(a).format(image=tmp_path / "image.rgb") for a in extra]
    proc = run_runner(runner_build, "--model", model, "--device", "cpu", *extra)
    assert proc.returncode == code, proc.stdout + proc.stderr
    assert "FATAL" in proc.stderr and message in proc.stderr, proc.stderr
