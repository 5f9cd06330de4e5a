"""Readings the correctness limits are set from; the benchmark's runs never
run this.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1 2 3 ... [--seconds 4] [--control] [--faults]

For each seed: one run of the cell as ``perfbench/run.py`` makes it (a
short window, the same sample of requests checked), printing every
reading of ``perfbench/check.py`` beside the run's ``correct``.  With
``--faults``, also the forward's readings with each of ``FAULTS`` planted
in what the program's forward returned in that run.  With ``--control``,
also the control on the same images: the float32 reference put in the
program's place, with the operands of every Linear and convolution
rounded to float8 e4m3 (the step below the configuration's bfloat16) and
its soft-NMS computed in bfloat16 (the step below that stage's float32),
judged by the float32 reference exactly as the program is.  One JSON line
per seed and side.  Needs the card, as the benchmark does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

READINGS = ("fwd.unmatched_share", "fwd.nlogit_gap_med", "fwd.nlogit_gap_p90", "fwd.box_gap_p90",
            "post.score_gap", "post.box_gap")


def _scaled_boxes(b, s, l):
    return b * 1.3, s, l


def _shifted_boxes(b, s, l):
    w = (b[:, 2] - b[:, 0])[:, None]
    return b + 0.15 * w * b.new_tensor([1.0, 0.0, 1.0, 0.0]), s, l


def _half_the_scores(b, s, l):
    lg = s.float().logit(eps=1e-7)
    lg[::2] += 1.0
    return b, lg.sigmoid().to(s.dtype), l


# faults planted in one image's pre-NMS detections (boxes, scores, labels)
FAULTS = {"boxes_x1.3": _scaled_boxes, "boxes_shifted_0.15w": _shifted_boxes,
          "half_the_scores_logit+1": _half_the_scores}


def control_readings(cell, seed: int, device) -> dict:
    """The control's worst readings over the first ``check_requests``
    requests' images of the seed's pool."""
    import torch

    from perfbench import check, harness, traffic
    from perfbench.reference import pipeline
    from perfbench.reference.model import Precision

    cfg, tr = cell.config, cell.traffic
    canvas, batch = tuple(tr["canvas"]), int(tr["batch"])
    pool = traffic.make_pool(tr, seed)
    ref = harness.reference_model(cfg, seed, device)
    ctl = harness.reference_model(cfg, seed, device, Precision(gemm=torch.float8_e4m3fn))
    pre = cfg["preprocess"]
    per_image = []
    with torch.no_grad(), harness.fp32_flags():
        for k in range(int(tr["check_requests"])):
            for i in pool.request(k, batch):
                img = pool.images[i]
                x, mask, scale = pipeline.preprocess(img, canvas[0], canvas[1], pre["mean"], pre["std"], device)
                b, s, l = (t[0] for t in ctl(x, mask))
                served = check.numpy_of(*pipeline.postprocess(b, s, l, scale, cfg, torch.bfloat16))
                want, want_scale = check.reference_view(cfg, ref, canvas, img)
                per_image.append(check.image_readings(cfg, want, want_scale, (b, s, l), served, device))
    del ref, ctl
    return check.worst(per_image)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args(argv)

    import os

    from perfbench import run as entry
    from perfbench import spec

    os.environ["TRITON_CACHE_DIR"] = os.path.join(entry.CACHE, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(entry.CACHE, "inductor")
    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell = spec.load(entry.ROOT, args.workload)
    limits = dict(cell.limits)
    cell.limits = {k: float("inf") for k in READINGS}
    for seed in args.seeds:
        t0 = time.perf_counter()
        result = harness.run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                                  FAULTS if args.faults else None)
        got = {k: c["value"] for k, c in result["checks"].items()}
        ok, _ = harness.check.judge(got, limits)
        line = {"workload": cell.name, "seed": seed, "side": "program", "readings": got,
                "correct_under_limits": ok and result["failed"] == 0, "attempted": result["attempted"],
                "setup_s": result["metrics"].get("setup_s", {}).get("value"),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        for name, readings in result.get("planted", {}).items():
            ok, _ = harness.check.judge(readings, {k: v for k, v in limits.items() if k in readings})
            print(json.dumps({"workload": cell.name, "seed": seed, "side": f"fault:{name}", "readings": readings,
                              "correct_under_limits": ok}), flush=True)
        torch.cuda.empty_cache()
        if args.control:
            t0 = time.perf_counter()
            got = control_readings(cell, seed, "cuda")
            ok, _ = harness.check.judge(got, limits)
            print(json.dumps({"workload": cell.name, "seed": seed, "side": "control", "readings": got,
                              "correct_under_limits": ok, "seconds": time.perf_counter() - t0}), flush=True)
            torch.cuda.empty_cache()
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
