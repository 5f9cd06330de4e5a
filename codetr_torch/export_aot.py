"""Export CLI, the counterpart of the JAX package's root ``export_aot.py``:
build the model (optionally with an mmdet ``.pth``), export its forward at a
fixed (height, width), save the program, reload it, print the reload's
drift against the in-process model, serve an image through it and time it.

    python -m codetr_torch.export_aot --config swin-l --dtype bfloat16 \\
        --height 768 --width 1152 --image image.npy --output out/

Writes into ``--output``: ``codetr.codetr.pt2`` (``torch.export.save``, the
weights inside) and ``codetr.codetr.pt2.meta.json``; with ``--image``,
``predictions.json`` and ``vis.jpg``; unless ``--skip-benchmark``,
``benchmark.json``.  ``--image`` takes an ``.npy`` (H, W, 3) uint8 RGB
array, or any file OpenCV reads.  Runs on the card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from codetr_torch.config import CONFIGS
from codetr_torch.inferencer import Inferencer
from codetr_torch.models.codetr import build_codetr, check_device
from codetr_torch.runtime.aot import (DTYPES, benchmark, compile_forward, load_executable,
                                      save_executable)
from codetr_torch.utils.image_io import read_image
from codetr_torch.utils.preprocess import preprocess_in_graph


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Export Co-DINO to a saved torch.export program")
    ap.add_argument("--config", default="swin-l", choices=sorted(CONFIGS),
                    help="model preset (or use --config-file)")
    ap.add_argument("--config-file", default=None, help="python config file (mmengine-style)")
    ap.add_argument("--weights", default=None, help="mmdet .pth checkpoint")
    ap.add_argument("--image", default=None,
                    help="test image: an .npy (H, W, 3) uint8 RGB array, or a file cv2 reads")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    ap.add_argument("--height", type=int, default=768)
    ap.add_argument("--width", type=int, default=1152)
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--output", default="codetr_torch_export")
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--score-threshold", type=float, default=0.0)  # test_cfg score_thr
    ap.add_argument("--iou-threshold", type=float, default=0.8)  # test_cfg nms iou
    ap.add_argument("--msda-impl", default="auto")
    ap.add_argument("--fuse-preprocess", action="store_true",
                    help="export the fused-serving form: the program takes (uint8 canvas, "
                    "(th, tw) int32) and normalises, pads and masks inside")
    ap.add_argument("--skip-benchmark", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def drift_inputs(example, seed: int = 0):
    """Seeded inputs shaped like the program's: a uint8 canvas and full
    (th, tw), or a normalised image and a mask with padding."""
    rng = np.random.default_rng(seed)
    a, b = example
    if a.dtype == torch.uint8:
        return torch.from_numpy(rng.integers(0, 256, tuple(a.shape), np.uint8)).to(a.device), b.clone()
    x = torch.from_numpy(rng.standard_normal(tuple(a.shape)).astype(np.float32)).to(a.device, a.dtype)
    m = torch.zeros_like(b)
    m[:, int(b.shape[1] * 0.8):] = 1.0
    return x, m


def max_drift(got, want) -> float:
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def main(argv=None) -> None:
    args = parse_args(argv)
    device = check_device(args.device)
    os.makedirs(args.output, exist_ok=True)
    dtype = DTYPES[args.dtype]
    if args.config_file:
        from codetr_torch.utils.config_loader import load_config_file

        cfg = load_config_file(args.config_file)
    else:
        cfg = CONFIGS[args.config]()

    print(f"building {args.config} ({args.dtype}) at {args.width}x{args.height} on {device} ...")
    model = build_codetr(cfg, args.weights, dtype=dtype, device=device, msda_impl=args.msda_impl)
    fn, example = compile_forward(model, height=args.height, width=args.width,
                                  batch_size=args.batch_size, dtype=dtype,
                                  fuse_preprocess=args.fuse_preprocess, preprocess_cfg=cfg.preprocess)
    exe_path = os.path.join(args.output, "codetr.codetr.pt2")
    save_executable(exe_path, fn, example, meta={
        "config": args.config_file or args.config, "dtype": args.dtype,
        "height": args.height, "width": args.width, "batch_size": args.batch_size,
        "fused_preprocess": args.fuse_preprocess,
    })
    print(f"saved program: {exe_path} ({os.path.getsize(exe_path) / 1e6:.1f} MB)")

    loaded = load_executable(exe_path, device=device)
    inputs = drift_inputs(example)
    with torch.no_grad():
        if args.fuse_preprocess:
            x, m = preprocess_in_graph(*inputs, mean=cfg.preprocess.mean, std=cfg.preprocess.std)
            eager = model(x.to(dtype), m)
        else:
            eager = model(*inputs)
    reloaded = loaded(*inputs)
    print(f"reload drift vs the in-process program: {max_drift(reloaded, fn(*inputs)):.2e}, "
          f"vs the in-process model: {max_drift(reloaded, eager):.2e}")

    if args.image:
        img = read_image(args.image)
        inf = Inferencer(model, height=args.height, width=args.width, batch_size=args.batch_size,
                         score_threshold=args.score_threshold, iou_threshold=args.iou_threshold,
                         compiled_fn=loaded, input_dtype=dtype,
                         device_preprocess=args.fuse_preprocess, device=device)
        dets = inf([img])
        print(f"detections above threshold: {int(dets[0].keep.sum())}")
        inf.dump_json(dets, os.path.join(args.output, "predictions.json"))
        inf.visualize(img, dets[0], os.path.join(args.output, "vis.jpg"))

    if not args.skip_benchmark:
        stats = benchmark(loaded, example, iterations=args.iterations, graph=device.type == "cuda")
        print(json.dumps(stats))
        with open(os.path.join(args.output, "benchmark.json"), "w") as f:
            json.dump(stats, f, indent=2)


if __name__ == "__main__":
    main()
