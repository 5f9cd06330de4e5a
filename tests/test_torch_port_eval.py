"""The port's COCO evaluation against the JAX package's, on the CPU.

- ``codetr_torch/utils/coco_eval.py`` (a numpy copy) against
  ``codetr_tpu/utils/coco_eval.py``: ``box_iou``, ``average_precision``,
  ``evaluate_detections`` and ``load_coco_annotations`` on identical inputs,
  to 1e-12 (the same float64 arithmetic in the same order), on the JAX
  suite's own hand cases (``tests/test_coco_eval.py``) and on 60 seeded
  random scenes with crowd gts, COCO areas across the area ranges, score
  ties, more than 100 detections in one (image, class), classes without
  gts and images without detections; and against the independent
  transcription ``tests/cocoeval_independent.py`` to 1e-9, as the JAX
  suite holds its own module.
- ``eval_coco.predict`` (the ``Inferencer``, tiny config, fp32, batch 2
  over 5 images of different sizes: the last batch is short) against the
  JAX evaluation loop of the root ``eval_coco.py`` on the same weights
  (``state_dict_from_jax``): per image, the detections matched set-wise at
  the ladder (scores 2e-4, boxes 0.1 px).
- ``python -m codetr_torch.eval_coco --device cpu`` (``.npy`` images,
  ``--weights`` a ``.pth`` whose ``meta`` holds numpy values) against the
  JAX ``eval_coco.py`` run in-process on the same images as PNGs.  The
  ground truth is built from the port's detections so that no legitimate
  difference (scores 2e-4, boxes 0.1 px) can change a match: see
  ``ground_truth``.  With every match and every rank fixed so, both CLIs
  score identical TP/FP sequences with the same float64 code, and the
  metrics must agree to 1e-12.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from codetr_tpu.utils import coco_eval as jax_coco_eval
from codetr_torch import eval_coco
from codetr_torch.inferencer import Inferencer
from codetr_torch.utils import coco_eval

from cocoeval_independent import evaluate as eval_independent
from test_torch_port_model import match_detections, perturbed_jax_params, port_from_jax
from torch_eval_truth import BOX_TOL, EVAL_SIZES, ground_truth, write_annotations
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
KEYS = ("mAP", "mAP_50", "mAP_75", "mAP_small", "mAP_medium", "mAP_large", "AR_100")
HW = 128
SIZES = EVAL_SIZES  # 5 images: batch 2 leaves the last batch short
SCORE_TOL = 2e-4  # the ladder: scores 2e-4, boxes 0.1 px (BOX_TOL)


def gt(boxes, labels, **kw):
    return {"boxes": np.asarray(boxes, float), "labels": np.asarray(labels), **kw}


def det(boxes, labels, scores):
    return {"boxes": np.asarray(boxes, float), "labels": np.asarray(labels), "scores": np.asarray(scores, float)}


# the JAX suite's hand cases (tests/test_coco_eval.py): (predictions, ground truths, classes)
HAND_CASES = {
    "perfect": ([det([[0, 0, 10, 10], [20, 20, 40, 40]], [0, 1], [1, 1]), det([[5, 5, 15, 15]], [0], [1])],
                [gt([[0, 0, 10, 10], [20, 20, 40, 40]], [0, 1]), gt([[5, 5, 15, 15]], [0])], 2),
    "wrong": ([det([[50, 50, 60, 60]], [0], [0.9])], [gt([[0, 0, 10, 10]], [0])], 1),
    "localization": ([det([[0, 0, 10, 7.5]], [0], [0.9])], [gt([[0, 0, 10, 10]], [0])], 1),
    "duplicates": ([det([[0, 0, 10, 10], [0, 0, 10, 10]], [0, 0], [0.9, 0.8])], [gt([[0, 0, 10, 10]], [0])], 1),
    "crowd": ([det([[0, 0, 10, 10], [55, 55, 70, 70], [60, 60, 90, 90]], [0, 0, 0], [0.9, 0.8, 0.7])],
              [gt([[0, 0, 10, 10], [50, 50, 100, 100]], [0, 0], iscrowd=np.array([False, True]))], 1),
    "crowd_off": ([det([[0, 0, 10, 10], [55, 55, 70, 70], [60, 60, 90, 90]], [0, 0, 0], [0.9, 0.8, 0.7])],
                  [gt([[0, 0, 10, 10], [50, 50, 100, 100]], [0, 0], iscrowd=np.array([False, False]))], 1),
    "area_ranges": ([det([[0, 0, 16, 16], [100, 100, 300, 300]], [0, 0], [0.9, 0.8])],
                    [gt([[0, 0, 16, 16], [100, 100, 300, 300]], [0, 0])], 1),
    "area_range_fp": ([det([[0, 0, 5, 5], [100, 100, 300, 300]], [0, 0], [0.95, 0.8])],
                      [gt([[100, 100, 300, 300]], [0])], 1),
    "two_images": ([det([[0, 0, 10, 10], [40, 40, 50, 50], [20, 20, 30, 30]], [0, 0, 0], [0.9, 0.8, 0.6]),
                    det([[0, 0, 10, 10]], [0], [0.7])],
                   [gt([[0, 0, 10, 10], [20, 20, 30, 30]], [0, 0]), gt([[0, 0, 10, 10]], [0])], 1),
}


def assert_metrics_close(got, want, tol):
    assert sorted(got) == sorted(KEYS) == sorted(want)
    for k in KEYS:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_evaluate_detections_matches_jax_on_the_hand_cases(name):
    preds, gts, num_classes = HAND_CASES[name]
    got = coco_eval.evaluate_detections(preds, gts, num_classes)
    assert_metrics_close(got, jax_coco_eval.evaluate_detections(preds, gts, num_classes), 1e-12)
    assert_metrics_close(got, eval_independent(preds, gts, num_classes), 1e-9)


def test_box_iou_and_average_precision_match_jax_on_the_hand_cases():
    a = np.array([[0, 0, 10, 10]], float)
    b = np.array([[0, 0, 10, 10], [5, 5, 15, 15], [20, 20, 30, 30]], float)
    np.testing.assert_array_equal(coco_eval.box_iou(a, b), jax_coco_eval.box_iou(a, b))
    assert abs(coco_eval.box_iou(a, b)[0, 1] - 25 / 175) < 1e-12
    args = (np.array([0.9, 0.8]), np.array([True, False]), np.zeros(2, bool), 1)
    assert coco_eval.average_precision(*args) == jax_coco_eval.average_precision(*args)
    assert coco_eval.average_precision(*args[:3], 0) == (pytest.approx(np.nan, nan_ok=True),) * 2


def random_scene(seed):
    """Seeded predictions and ground truths that reach every branch of the
    protocol: crowd gts (IoU over the detection's area), COCO ``areas``
    apart from the boxes' and box sizes across the small / medium / large
    ranges, score ties (scores rounded to a tenth in half the scenes), an
    (image, class) with more than 100 detections (in every fifth scene),
    a class that has detections but no gt, and an image with no detections
    (in every third scene)."""
    rng = np.random.default_rng(seed)
    num_classes = int(rng.integers(1, 4)) + 1  # the last class never has a gt
    preds, gts = [], []
    for i in range(int(rng.integers(1, 4))):
        ng = int(rng.integers(0, 8))
        gwh = rng.uniform(4, 150, (ng, 2))
        gxy = rng.uniform(0, 400, (ng, 2))
        boxes = np.concatenate([gxy, gxy + gwh], 1)
        g = gt(boxes, rng.integers(0, num_classes - 1, ng), iscrowd=rng.uniform(size=ng) < 0.25)
        if seed % 2:
            g["areas"] = gwh.prod(1) * rng.uniform(0.5, 1.0, ng)  # COCO areas are the masks'
        nd = 0 if (seed % 3 == 0 and i == 0) else int(rng.integers(0, 15))
        many = seed % 5 == 0 and i == 0 and ng > 0
        nd += 110 if many else 0
        d = []
        for k in range(nd):
            if ng and k % 2 == 0:
                d.append(boxes[int(rng.integers(0, ng))] + rng.normal(0, 6, 4))
            else:
                xy, wh = rng.uniform(0, 400, 2), rng.uniform(4, 150, 2)
                d.append(np.concatenate([xy, xy + wh]))
        scores = rng.uniform(0, 1, nd)
        if seed % 2 == 0:
            scores = np.round(scores, 1)
        labels = rng.integers(0, num_classes, nd)
        if many:
            labels[:110] = g["labels"][0]  # one (image, class) over maxDets
        preds.append(det(np.asarray(d).reshape(nd, 4), labels, scores))
        gts.append(g)
    return preds, gts, num_classes


@pytest.mark.parametrize("seed", range(60))
def test_evaluate_detections_matches_jax_on_random_scenes(seed):
    preds, gts, num_classes = random_scene(seed)
    got = coco_eval.evaluate_detections(preds, gts, num_classes)
    assert_metrics_close(got, jax_coco_eval.evaluate_detections(preds, gts, num_classes), 1e-12)
    assert_metrics_close(got, eval_independent(preds, gts, num_classes), 1e-9)
    g = gts[0]
    d = np.concatenate([p["boxes"] for p in preds])
    crowd = g["iscrowd"]
    np.testing.assert_array_equal(coco_eval.box_iou(d, g["boxes"], crowd),
                                  jax_coco_eval.box_iou(d, g["boxes"], crowd))
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(0, 40))
    ap_args = (np.round(rng.uniform(0, 1, n), 1), rng.uniform(size=n) < 0.5, rng.uniform(size=n) < 0.2,
               int(rng.integers(1, 30)))
    assert coco_eval.average_precision(*ap_args) == jax_coco_eval.average_precision(*ap_args)


def test_load_coco_annotations_matches_jax(tmp_path):
    """COCO's 80 non-contiguous category ids (densified in sorted order),
    crowd annotations, annotations without ``area`` or ``iscrowd``, and an
    image without annotations."""
    rng = np.random.default_rng(3)
    cat_ids = COCO_CATEGORY_IDS[::-1]  # listed out of order
    images = [{"id": i, "file_name": f"{i:012d}.jpg"} for i in (139, 285, 632, 724)]
    anns = []
    for k in range(25):
        x, y, w, h = (float(v) for v in rng.uniform(1, 200, 4))
        ann = {"id": k, "image_id": images[k % 3]["id"], "category_id": int(rng.choice(cat_ids)),
               "bbox": [x, y, w, h]}
        if k % 4:
            ann["area"] = w * h * 0.7
        if k % 5 == 0:
            ann["iscrowd"] = 1
        elif k % 5 == 1:
            ann["iscrowd"] = 0
        anns.append(ann)
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c, "name": str(c)} for c in cat_ids]}))
    got, want = coco_eval.load_coco_annotations(str(path)), jax_coco_eval.load_coco_annotations(str(path))
    assert sorted(got) == sorted(want) == [139, 285, 632, 724]
    for i in want:
        assert sorted(got[i]) == sorted(want[i])
        assert got[i]["file_name"] == want[i]["file_name"]
        for k in ("boxes", "labels", "iscrowd", "areas"):
            assert got[i][k].dtype == want[i][k].dtype, k
            np.testing.assert_array_equal(got[i][k], want[i][k], err_msg=k)
    assert len(got[724]["labels"]) == 0 and got[139]["labels"].max() < 80


# COCO 2017's category ids: 80 of 1..90
COCO_CATEGORY_IDS = [i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83)]


# ---- the evaluation path: predict and the CLI against the JAX script ----


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The tiny model's seeded weights (the port's from ``state_dict_from_jax``
    and a ``.pth`` of them whose ``meta`` holds numpy values), and 5 images
    of different sizes as ``.npy`` (the port's CLI) and PNG (the JAX one)."""
    import cv2

    root = tmp_path_factory.mktemp("coco")
    model = port_from_jax(perturbed_jax_params(seed=2))
    weights = root / "weights.pth"
    torch.save({"state_dict": model.state_dict(),
                "meta": {"seed": np.int64(0), "iter": np.arange(3),
                         "dataset_meta": {"CLASSES": [f"c{i}" for i in range(7)]}}}, weights)
    rng = np.random.default_rng(4)
    names = []
    for i, (h, w) in enumerate(SIZES):
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        np.save(root / f"im{i}.npy", img)
        cv2.imwrite(str(root / f"im{i}.png"), img[..., ::-1])  # RGB -> BGR on disk
        names.append(f"im{i}")
    preds = eval_coco.predict(Inferencer(model, height=HW, width=HW, batch_size=2, device="cpu"),
                              [str(root / f"{n}.npy") for n in names])
    return {"root": root, "weights": str(weights), "names": names, "preds": preds, "model": model}


def load_jax_eval_coco():
    spec = importlib.util.spec_from_file_location("jax_eval_coco", REPO / "eval_coco.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_cli(scene):
    """The JAX ``eval_coco.py`` run in-process on the PNGs (tiny, fp32, batch
    2, its defaults otherwise): its printed metrics, and the per-image
    predictions its loop hands to ``evaluate_detections``."""
    anns, made = ground_truth(scene["preds"])
    root = scene["root"]
    ann_png = write_annotations(root / "png.json", scene["names"], ".png", anns)
    captured = {}
    evaluate = jax_coco_eval.evaluate_detections

    def capture(preds, gts, num_classes):
        captured["preds"] = preds
        return evaluate(preds, gts, num_classes)

    argv = ["eval_coco.py", "--ann", ann_png, "--img-dir", str(root), "--config", "tiny",
            "--height", str(HW), "--width", str(HW), "--batch-size", "2", "--dtype", "float32",
            "--weights", scene["weights"]]
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_coco_eval, "evaluate_detections", capture)
        mp.setattr("sys.argv", argv)
        mp.setattr(sys, "path", list(sys.path))  # the script prepends its directory
        for key in ("TPU_ACCELERATOR_TYPE", "TPU_WORKER_HOSTNAMES", "JAX_COMPILATION_CACHE_DIR"):
            if key in os.environ:  # the script's setdefault keeps it
                mp.setenv(key, os.environ[key])
            else:  # restored (removed) on exit
                mp.delenv(key, raising=False)
        module = load_jax_eval_coco()
        with contextlib.redirect_stdout(out):
            module.main()
    text = out.getvalue()
    metrics = json.loads(text[text.index("{"):])
    return {"metrics": metrics, "preds": captured["preds"], "anns": anns, "made": made}


def test_predict_matches_the_jax_evaluation_loop(scene, jax_cli):
    """Per image, the kept detections in original-image pixels, set-wise at
    the ladder; 5 images at batch 2, so the last batch is padded (the port
    repeats an image, the JAX script pads with zeros)."""
    got, want = scene["preds"], jax_cli["preds"]
    assert len(got) == len(want) == len(SIZES)
    for g, w in zip(got, want):
        assert set(g) == {"boxes", "scores", "labels"} and len(g["scores"]) == len(w["scores"]) > 0
        assert g["boxes"].shape == (len(g["scores"]), 4)
        assert match_detections(g["boxes"], g["labels"], w["boxes"], w["labels"], box_tol=BOX_TOL) == 0
        np.testing.assert_allclose(np.sort(g["scores"]), np.sort(w["scores"]), atol=SCORE_TOL)
        assert np.isfinite(g["boxes"]).all() and np.isfinite(g["scores"]).all()


def test_cli_matches_the_jax_cli(scene, jax_cli, capsys):
    """``python -m codetr_torch.eval_coco --device cpu`` on the ``.npy``
    images with the ``.pth`` (numpy values in its ``meta``) against the JAX
    script on the PNGs: the metrics to 1e-12 (see ``ground_truth``), and
    the printed lines: progress, the metrics JSON, the seconds."""
    assert jax_cli["made"] >= 5
    root = scene["root"]
    ann_npy = write_annotations(root / "npy.json", scene["names"], ".npy", jax_cli["anns"])
    timings = {}
    got = eval_coco.main(["--ann", ann_npy, "--img-dir", str(root), "--config", "tiny",
                          "--height", str(HW), "--width", str(HW), "--batch-size", "2",
                          "--dtype", "float32", "--weights", scene["weights"], "--device", "cpu"], timings)
    want = jax_cli["metrics"]
    assert_metrics_close(got, want, 1e-12)
    assert 0 < got["mAP"] < got["mAP_50"] <= 1 and 0 < got["AR_100"] < 1
    lines = capsys.readouterr().out.rstrip("\n").split("\n")  # the progress line rewrites itself with \r
    assert lines[0] == f"\r{len(SIZES)}/{len(SIZES)}"
    tail = json.loads(lines[-1])
    assert json.loads("\n".join(lines[1:-1])) == got
    assert tail["images"] == len(SIZES) and set(tail["seconds"]) == {"read", "serve", "evaluate"}
    assert set(timings) == {"read_s", "serve_s", "evaluate_s"} and timings["serve_s"] > 0


def test_cli_defaults_are_the_jax_scripts():
    """The JAX script's flags and defaults, plus ``--device`` (the card)."""
    args = eval_coco.parse_args(["--ann", "a.json", "--img-dir", "d"])
    assert vars(args) == {"ann": "a.json", "img_dir": "d", "config": "swin-l", "weights": None,
                          "height": 768, "width": 1152, "batch_size": 4, "dtype": "bfloat16",
                          "score_threshold": 0.0, "iou_threshold": 0.8, "nms_type": None,
                          "max_images": None, "msda_impl": "auto", "device": "cuda"}
    src = (REPO / "eval_coco.py").read_text()
    for flag in vars(args):
        if flag != "device":
            assert f'"--{flag.replace("_", "-")}"' in src, flag


def test_cli_on_cuda_without_a_card_raises(scene, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_port_cuda.py runs the CLI on it")
    ann = write_annotations(tmp_path / "a.json", scene["names"], ".npy", [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        eval_coco.main(["--ann", ann, "--img-dir", str(scene["root"]), "--config", "tiny"])


def test_read_image_needs_cv2_only_for_image_files(tmp_path, monkeypatch):
    """``.npy`` arrays are read without cv2; an image file without cv2
    raises and names the ``.npy`` route; both CLIs take the one reader."""
    from codetr_torch import export_aot
    from codetr_torch.utils import image_io

    assert export_aot.read_image is image_io.read_image is eval_coco.read_image
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3), np.uint8)
    np.save(tmp_path / "a.npy", img)

    def no_cv2():
        raise ImportError("no cv2")

    monkeypatch.setattr(image_io, "import_cv2", no_cv2)
    np.testing.assert_array_equal(image_io.read_image(str(tmp_path / "a.npy")), img)
    with pytest.raises(ImportError, match=r"\.npy"):
        image_io.read_image(str(tmp_path / "a.png"))
