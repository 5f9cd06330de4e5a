"""The port's export, reload and fused-serving path against the JAX package.

On the tiny model at 96x96 with weights carried from the JAX package
(``state_dict_from_jax``): ``runtime.aot.compile_forward`` records the MSDA
kernels as ``codetr::`` op nodes (not a traced copy of the plain version),
the saved program reloads with drift 0, a bad magic raises, and an fp32
program runs with TF32 off and gives the caller's flags back.  The fused
form (uint8 canvas and (th, tw) in, preprocessing in the program) matches
the JAX ``compile_forward(fuse_preprocess=True)`` set-wise at the ladder
(scores 2e-4, boxes 0.1 px); ``preprocess_in_graph`` matches the JAX
function bit for bit and ``resize_to_canvas`` the JAX one (cv2) on 50
random sizes.  The ``Inferencer``'s fused and batched modes, ``dump_json``
and ``visualize`` are held against host mode, single images and the JAX
package.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from codetr_tpu.config import PreprocessConfig as JaxPreprocessConfig
from codetr_tpu.config import tiny_test_config as jax_tiny_test_config
from codetr_tpu.inferencer import Detections as JaxDetections
from codetr_tpu.inferencer import Inferencer as JaxInferencer
from codetr_tpu.models.codetr import CoDETR as JaxCoDETR
from codetr_tpu.runtime.aot import compile_forward as jax_compile_forward
from codetr_tpu.utils.preprocess import preprocess_in_graph as jax_preprocess_in_graph
from codetr_tpu.utils.preprocess import resize_to_canvas as jax_resize_to_canvas
from codetr_tpu.utils.visualize import draw_detections as jax_draw_detections
from codetr_torch.config import PreprocessConfig
from codetr_torch.inferencer import Detections, Inferencer
from codetr_torch.runtime import aot
from codetr_torch.utils.preprocess import preprocess_in_graph, resize_to_canvas
from codetr_torch.utils.visualize import draw_detections

from test_torch_port_model import match_detections, perturbed_jax_params, port_from_jax

HW = 96
MSDA_OPS = {"codetr.msda_packed.default": 2, "codetr.msda_reference.default": 2}


@pytest.fixture(scope="module")
def params():
    return perturbed_jax_params(seed=2, input_shape=(HW, HW))


@pytest.fixture(scope="module")
def port(params):
    return port_from_jax(params)


@pytest.fixture(scope="module")
def exported(port):
    return aot.compile_forward(port, height=HW, width=HW)


@pytest.fixture(scope="module")
def fused(port):
    return aot.compile_forward(port, height=HW, width=HW, batch_size=2, fuse_preprocess=True,
                               preprocess_cfg=port.cfg.preprocess)


@pytest.fixture(scope="module")
def saved(exported, tmp_path_factory):
    """The plain program saved once, with the meta ``export_aot`` writes."""
    fn, example = exported
    path = str(tmp_path_factory.mktemp("aot") / "tiny.codetr.pt2")
    aot.save_executable(path, fn, example, meta={"config": "tiny", "dtype": "float32", "height": HW,
                                                  "width": HW, "batch_size": 1, "fused_preprocess": False})
    return path


@pytest.fixture(scope="module")
def jax_fused(params):
    cfg = jax_tiny_test_config()
    return jax_compile_forward(JaxCoDETR(cfg=cfg, msda_impl="auto"), params, height=HW, width=HW,
                               batch_size=2, fuse_preprocess=True, preprocess_cfg=cfg.preprocess)


def model_inputs(seed=0, bs=1):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((bs, HW, HW, 3)).astype(np.float32))
    m = torch.zeros(bs, HW, HW)
    m[:, 70:] = 1.0
    m[:, :, 80:] = 1.0
    return x, m


def canvases(seed, bs=2):
    """uint8 canvases with bytes everywhere (the padding must be masked) and
    valid regions smaller than the canvas."""
    rng = np.random.default_rng(seed)
    canvas = rng.integers(0, 256, (bs, HW, HW, 3), np.uint8)
    thw = np.asarray([[HW - 20 * i, HW - 7 - 9 * i] for i in range(bs)], np.int32)
    return canvas, thw


def images(seed, sizes=((70, 96), (96, 50), (40, 120))):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), np.uint8) for h, w in sizes]


def test_exported_program_holds_the_msda_ops(exported):
    """The graph holds one ``codetr::`` node per MSDA layer (2 encoder, 2
    decoder), exported on the CPU: the kernels survive export."""
    fn, _ = exported
    assert aot.msda_nodes(fn.exported) == MSDA_OPS


@pytest.fixture(scope="module")
def loaded(saved):
    return aot.load_executable(saved, device="cpu")


def test_save_load_round_trip_has_no_drift(port, exported, saved, loaded):
    fn, _ = exported
    meta = json.loads(open(saved + ".meta.json").read())
    assert meta["magic"] == aot.MAGIC
    assert meta["in_avals"] == [[[1, HW, HW, 3], "float32"], [[1, HW, HW], "float32"]]
    assert meta["msda_ops"] == MSDA_OPS
    assert aot.msda_nodes(loaded.exported) == MSDA_OPS
    x, m = model_inputs()
    with torch.no_grad():
        want = port(x, m)
    for got in (fn(x, m), loaded(x, m)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_bad_magic_raises(saved, tmp_path):
    """A meta without the port's magic (here the JAX package's) raises
    before the program is read."""
    meta = json.loads(open(saved + ".meta.json").read())
    meta["magic"] = "codetr-tpu-xla-v1"
    path = str(tmp_path / "bad.codetr.pt2")
    with open(path + ".meta.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="magic"):
        aot.load_executable(path, device="cpu")


class ConvFlags(torch.utils._python_dispatch.TorchDispatchMode):
    """Records (cuDNN, matmul) TF32 flags each time a convolution runs: the
    exported graph has no ``nn.Conv2d`` to hook."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "convolution" in str(func):
            self.seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def caller_flags(request):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (cudnn.allow_tf32, matmul.allow_tf32)
    cudnn.allow_tf32, matmul.allow_tf32 = request.param
    yield request.param
    cudnn.allow_tf32, matmul.allow_tf32 = saved


@pytest.mark.parametrize("caller_flags", [(True, False), (True, True)], indirect=True)
def test_fp32_program_runs_without_tf32(loaded, caller_flags):
    """A reloaded fp32 program's convolutions see TF32 off (the meta's dtype
    picks ``full_fp32``); after the call the caller's flags are back.  A
    bf16 program leaves them alone."""
    x, m = model_inputs()
    with ConvFlags() as mode:
        loaded(x, m)
    assert mode.seen and all(s == (False, False) for s in mode.seen), mode.seen
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == caller_flags
    with ConvFlags() as mode:
        aot.Program(loaded.exported, torch.bfloat16)(x, m)
    assert mode.seen and all(s == caller_flags for s in mode.seen)


def test_fused_program_matches_jax(port, fused, jax_fused):
    """The port's fused program against the JAX fused executable on the same
    canvases (padding bytes included): detections set-wise at the ladder;
    and against the port's eager model on ``preprocess_in_graph``'s
    output, exactly."""
    fn, example = fused
    assert example[0].dtype == torch.uint8 and example[1].dtype == torch.int32
    assert aot.msda_nodes(fn.exported) == MSDA_OPS
    jfn, _ = jax_fused
    canvas, thw = canvases(3)
    got = fn(torch.from_numpy(canvas), torch.from_numpy(thw))
    want = [np.asarray(a) for a in jfn(jnp.asarray(canvas), jnp.asarray(thw))]
    for j in range(2):
        assert match_detections(got[0][j].numpy(), got[2][j].numpy(), want[0][j], want[2][j],
                                box_tol=0.1) == 0
        np.testing.assert_allclose(np.sort(got[1][j].numpy()), np.sort(want[1][j]), atol=2e-4)
    cfg = port.cfg.preprocess
    x, m = preprocess_in_graph(torch.from_numpy(canvas), torch.from_numpy(thw), mean=cfg.mean, std=cfg.std)
    with torch.no_grad():
        eager = port(x, m)
    for g, e in zip(got, eager):
        assert torch.equal(g, e)


def test_preprocess_in_graph_matches_jax_bit_for_bit():
    cfg = PreprocessConfig()
    canvas, thw = canvases(4, bs=3)
    got = preprocess_in_graph(torch.from_numpy(canvas), torch.from_numpy(thw), mean=cfg.mean, std=cfg.std)
    jcfg = JaxPreprocessConfig()
    want = jax.jit(lambda c, t: jax_preprocess_in_graph(c, t, mean=tuple(jcfg.mean), std=tuple(jcfg.std)))(
        jnp.asarray(canvas), jnp.asarray(thw))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("seed", range(50))
def test_resize_to_canvas_matches_jax(seed):
    """The port's integer resize onto the canvas against the JAX host path
    (``cv2.resize``), bit for bit, with the same (th, tw) and scale."""
    rng = np.random.default_rng(1000 + seed)
    h, w = (int(v) for v in rng.integers(8, 260, 2))
    H, W = (int(v) for v in rng.integers(32, 160, 2))
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    canvas, thw, sf = resize_to_canvas(img, H, W, device="cpu")
    want_canvas, want_thw, want_sf = jax_resize_to_canvas(img, H, W)
    assert thw == want_thw and sf == want_sf
    np.testing.assert_array_equal(canvas.numpy(), want_canvas)


def assert_same_detections(got, want, atol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.keep, w.keep)
        np.testing.assert_allclose(g.scores, w.scores, atol=atol, rtol=0)
        np.testing.assert_allclose(g.boxes[g.keep], w.boxes[w.keep], atol=atol * 10, rtol=0)
        np.testing.assert_array_equal(g.labels[g.keep], w.labels[w.keep])


def test_inferencer_device_preprocess_matches_host_and_jax(port, params, fused, jax_fused):
    """The fused Inferencer (eager, and through the exported fused program)
    gives the host-preprocess Inferencer's detections; against the JAX
    ``Inferencer(device_preprocess=True)`` set-wise at the ladder.  Three
    images at batch 2: the last batch is padded."""
    imgs = images(5)
    kw = dict(height=HW, width=HW, batch_size=2, device="cpu")
    host = Inferencer(port, **kw)(imgs)
    dev = Inferencer(port, device_preprocess=True, **kw)(imgs)
    exp = Inferencer(port, device_preprocess=True, compiled_fn=fused[0], **kw)(imgs)
    assert_same_detections(dev, host)
    assert_same_detections(exp, dev, atol=0)
    cfg = jax_tiny_test_config()
    want = JaxInferencer(JaxCoDETR(cfg=cfg, msda_impl="auto"), params, cfg, height=HW, width=HW,
                         batch_size=2, compiled_fn=jax_fused[0], device_preprocess=True)(imgs)
    for g, w in zip(dev, want):
        gc, wc = g.compact(), w.compact()
        assert len(gc.scores) == len(wc.scores)
        assert match_detections(gc.boxes, gc.labels, wc.boxes, wc.labels, box_tol=0.1) == 0
        np.testing.assert_allclose(np.sort(gc.scores), np.sort(wc.scores), atol=2e-4)


def test_batched_inferencer_matches_single_with_a_ragged_tail(port):
    imgs = images(6, sizes=((70, 96), (96, 50), (40, 120), (96, 96), (33, 61)))
    single = Inferencer(port, height=HW, width=HW, batch_size=1, device="cpu")(imgs)
    batched = Inferencer(port, height=HW, width=HW, batch_size=3, device="cpu")(imgs)
    assert_same_detections(batched, single)


def random_detections(seed, n=12):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 80, (n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1).astype(np.float32)
    return (boxes, rng.uniform(0, 1, n).astype(np.float32), rng.integers(0, 7, n).astype(np.int32),
            rng.random(n) < 0.6)


def test_dump_json_matches_jax_to_dict(port, tmp_path):
    dets = [random_detections(s) for s in (1, 2)]
    path = tmp_path / "predictions.json"
    Inferencer(port, height=HW, width=HW, device="cpu").dump_json([Detections(*d) for d in dets], str(path))
    assert json.loads(path.read_text()) == [JaxDetections(*d).to_dict() for d in dets]


def test_visualize_writes_an_image(port, tmp_path):
    """``visualize`` draws what the JAX ``draw_detections`` draws and writes
    it to disk."""
    import cv2

    img = images(7, sizes=((90, 110),))[0]
    det = Detections(*random_detections(3))
    inf = Inferencer(port, height=HW, width=HW, device="cpu", classes=[f"c{i}" for i in range(7)])
    path = str(tmp_path / "vis.png")
    vis = inf.visualize(img, det, path)
    np.testing.assert_array_equal(vis, jax_draw_detections(img, JaxDetections(*random_detections(3)),
                                                           inf.classes))
    np.testing.assert_array_equal(draw_detections(img, det, inf.classes), vis)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], vis)
