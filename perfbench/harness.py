"""One run of one cell: set-up, the measured window, the correctness check
and the metrics, on a given device.  ``perfbench/run.py`` is the entry
that refuses to run without a card; the tests call ``run_cell`` on the
CPU at a tiny size.

In the window the cell's loop driver (``perfbench/loops/<loop>.py``, the
traffic file's ``loop``) sends requests through a ``Window``: each hands
``batch`` images of the pool (RGB uint8 numpy arrays) to
``Inferencer.__call__`` and gets their ``Detections`` on the host.
Requests start while the window's ``seconds`` have not passed, and the
window ends when the last one returns.
"""

from __future__ import annotations

import gc
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench import check, traffic, weights
from perfbench.reference.model import CoDINO
from perfbench.spec import Cell
from perfbench.trace import REQUEST, TraceView, breakdown, capture

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "codetr_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclass
class Run:
    """What a metric reader reads."""

    cell: Cell
    setup_s: float
    seconds: float = 0.0  # the window's length asked for
    device: torch.device = torch.device("cpu")
    window_s: float = 0.0
    images: int = 0  # images whose detections reached the host in the window
    latencies_ms: List[float] = field(default_factory=list)
    trace: Optional[TraceView] = None  # host and device: the named ranges' device time
    traced_images: int = 0  # images of ``trace``
    device_trace: Optional[TraceView] = None  # device alone: busy, idle, kernel times
    window_peak_bytes: int = 0
    card: str = "cpu"

    @property
    def canvas(self):
        return tuple(self.cell.traffic["canvas"])

    @property
    def batch(self) -> int:
        return int(self.cell.traffic["batch"])


def valid(dets, n: int, max_per_img: int) -> bool:
    """``n`` Detections of ``max_per_img`` rows with finite kept boxes."""
    if len(dets) != n:
        return False
    for d in dets:
        shapes = (d.boxes.shape, d.scores.shape, d.labels.shape, d.keep.shape)
        if shapes != ((max_per_img, 4), (max_per_img,), (max_per_img,), (max_per_img,)):
            return False
        if not np.isfinite(d.boxes[d.keep]).all():
            return False
    return True


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ReplayTimer:
    """CUDA events around every replay of the Inferencer's captured
    postprocess graphs (``Inferencer.postprocess_programs``) while it is
    installed: the profiler drops a replayed graph's kernels, so their
    device time comes from here.  ``remove()`` -> each replay's µs."""

    def __init__(self, inferencer):
        self.replays = list(getattr(inferencer, "postprocess_programs", {}).values())
        self.events = []
        for r in self.replays:
            r.graph = _TimedGraph(r.graph, self.events)

    def remove(self) -> List[float]:
        for r in self.replays:
            r.graph = r.graph.graph
        for _, end in self.events:
            end.synchronize()
        return [start.elapsed_time(end) * 1e3 for start, end in self.events]


class _TimedGraph:
    def __init__(self, graph, events):
        self.graph, self.events = graph, events

    def replay(self):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        self.graph.replay()
        end.record()
        self.events.append((start, end))

    def __getattr__(self, name):
        return getattr(self.graph, name)


class Window:
    """The measured window, as a loop driver (``perfbench/loops/<loop>.py``,
    ``run(window)``) drives it: the driver decides which requests to send
    and when, while ``closed()`` is false; ``serve`` sends one and keeps
    its record.  With ``trace``, from a third of the window on, the next
    ``trace_requests`` requests are traced on the device alone, then as
    many with the host's ops."""

    def __init__(self, run: Run, inferencer, tap, pool, trace: bool):
        self.run, self.inferencer, self.tap, self.pool = run, inferencer, tap, pool
        self.batch, self.seconds = run.batch, run.seconds
        self.max_per_img = run.cell.config["head"]["max_per_img"]
        self.records = []  # (pool indices, output index or None, detections or None)
        self.failed = 0
        self.n_trace = int(run.cell.traffic["trace_requests"]) if trace else 0
        self.phases = [False, True] if self.n_trace else []  # the ``host`` argument of each trace
        self.tracer = self.holder = self.timer = None
        self.traced = 0
        self.shown = False
        self.t0 = self.t_end = time.perf_counter()

    def closed(self) -> bool:
        """Whether the window's seconds have passed: no request starts after."""
        return time.perf_counter() - self.t0 >= self.seconds

    def serve(self, idx: List[int], sent: Optional[float] = None) -> bool:
        """Sends the pool's images ``idx`` as one request and waits for its
        answer; its latency runs from ``sent`` (a ``perf_counter`` time;
        default: now) to the answer.  -> whether it was answered well (a
        failed request counts in ``failed`` and misses every latency)."""
        t0 = time.perf_counter()
        sent = t0 if sent is None else sent
        if self.phases and self.holder is None and t0 - self.t0 >= self.seconds / 3:
            self.tracer = capture(host=self.phases[0])
            self.holder, self.traced = self.tracer.__enter__(), 0
            self.timer = ReplayTimer(self.inferencer) if self.run.device.type == "cuda" else None
        n_out = len(self.tap.outputs)
        try:
            with torch.profiler.record_function(REQUEST):
                dets = self.inferencer([self.pool.images[i] for i in idx])
            ok = valid(dets, self.batch, self.max_per_img)
        except Exception:
            ok, dets = False, None
            if not self.shown:
                traceback.print_exc()
                self.shown = True
        self.t_end = time.perf_counter()
        self.records.append((idx, n_out if len(self.tap.outputs) == n_out + 1 else None, dets if ok else None))
        if ok:
            self.run.latencies_ms.append((self.t_end - sent) * 1e3)
            self.run.images += self.batch
        else:
            self.failed += 1
        if self.holder is not None:
            self.traced += 1
            if self.traced == self.n_trace:
                self._close()
        return ok

    def _close(self) -> None:
        self.tracer.__exit__(None, None, None)
        view = self.holder.view
        if self.timer is not None and not view.add_replays(self.timer.remove()):
            print("perfbench: the trace's graph launches and the timed replays differ in number; "
                  "the postprocess replays are left out of it", file=sys.stderr)
        if self.phases.pop(0):
            self.run.trace, self.run.traced_images = view, self.traced * self.batch
        else:
            self.run.device_trace = view
        self.tracer = self.holder = self.timer = None

    def finish(self) -> None:
        """Closes an open trace; the window ends when the last request returned."""
        if self.holder is not None:
            self._close()
        self.run.window_s = self.t_end - self.t0


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float, faults=None) -> dict:
    """One run; -> the result line's object (without the import check).
    ``faults`` (calibration alone): as ``check_sample`` takes them; their
    readings go under ``planted``."""
    device = torch.device(device)
    cfg, tr = cell.config, cell.traffic
    batch, canvas = int(tr["batch"]), tuple(tr["canvas"])
    max_per_img = cfg["head"]["max_per_img"]

    # ---- set-up: weights, the program, the pool, a request for each image size
    sd = weights.make_state_dict(cfg, seed, device)
    inferencer, tap = cell.build(cfg, sd, canvas, batch, device)
    del sd
    pool = traffic.make_pool(tr, seed)
    for k in pool.warmup(batch):
        if not valid(inferencer([pool.images[i] for i in pool.request(k, batch)]), batch, max_per_img):
            raise RuntimeError("the warm-up's detections are malformed")
    _sync(device)
    run = Run(cell, setup_s=time.perf_counter() - t_start, seconds=seconds, device=device)
    if device.type == "cuda":
        run.card = torch.cuda.get_device_name(device)
        torch.cuda.reset_peak_memory_stats(device)

    # ---- the window
    tap.recording = True
    window = Window(run, inferencer, tap, pool, trace)
    cell.loop(window)
    window.finish()
    tap.recording = False
    _sync(device)
    peak = 0
    if device.type == "cuda":
        run.window_peak_bytes = torch.cuda.max_memory_allocated(device)
        peak = run.window_peak_bytes

    # ---- correctness, after the window, with the program freed
    records, failed, outputs = window.records, window.failed, tap.outputs
    del inferencer, tap, window
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = check_sample(cell, seed, pool, records, outputs, device, faults)
    readings, planted = readings if faults else (readings, None)
    correct, checks = check.judge(readings, cell.limits)
    correct = correct and failed == 0

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader(run)
        if value is not None:
            metrics[m.name] = {"value": value, "unit": m.unit}
    result = {
        "correct": bool(correct),
        "attempted": len(records),
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if device.type == "cuda" else device.type, "kind": run.card,
                   "count": cell.chips, "memory_peak_bytes": int(peak)},
    }
    if trace and run.device_trace is not None:
        busy, _ = run.device_trace.busy()
        lo, hi = run.device_trace.window()
        result["device"].update(busy_s=busy / 1e6, window_s=(hi - lo) / 1e6)
        result["breakdown"] = breakdown(run.device_trace, run.trace)
    if planted is not None:
        result["planted"] = planted
    result["checks"] = checks
    return result


def check_sample(cell: Cell, seed: int, pool, records, outputs, device, faults=None):
    """Readings over a seeded sample of the window's answered requests, the
    one holding the largest image among them.  With ``faults`` ({name:
    fault(boxes, scores, labels) -> same, on one image's pre-NMS
    detections}): -> (readings, {name: the forward's readings with the
    fault planted in what the program returned})."""
    cfg, tr = cell.config, cell.traffic
    canvas = tuple(tr["canvas"])
    answered = [r for r in records if r[1] is not None and r[2] is not None]
    faults = faults or {}
    if not answered:
        inf = {k: float("inf") for k in cell.limits}
        return (inf, {f: dict(inf) for f in faults}) if faults else inf
    rng = np.random.default_rng((int(seed) & weights.SEED_MASK) ^ 0x5EED)
    n = min(len(answered), int(tr["check_requests"]))
    largest = max(range(len(answered)),
                  key=lambda i: max(pool.images[j].size for j in answered[i][0]))
    rest = [i for i in range(len(answered)) if i != largest]
    picks = [largest] + list(rng.choice(rest, n - 1, replace=False)) if n > 1 else [largest]
    model = reference_model(cfg, seed, device)
    per_image, planted = [], {f: [] for f in faults}
    with fp32_flags():
        for i in picks:
            idx, oi, dets = answered[i]
            boxes, scores, labels = outputs[oi]
            for j, pi in enumerate(idx):
                d = dets[j]
                ref, scale = check.reference_view(cfg, model, canvas, pool.images[pi])
                pre = (boxes[j], scores[j], labels[j])
                per_image.append(check.image_readings(
                    cfg, ref, scale, pre, (d.boxes, d.scores, d.labels, d.keep), device))
                for f, fault in faults.items():
                    planted[f].append(check.forward_readings(check.numpy_of(*fault(*pre)), ref))
    if faults:
        return check.worst(per_image), {f: check.worst(r) for f, r in planted.items()}
    return check.worst(per_image)


def reference_model(cfg: dict, seed: int, device, prec=None) -> CoDINO:
    """The float32 reference with the run's weights, made again from the seed."""
    with torch.device(device):
        model = CoDINO(cfg, prec)
    model.load_state_dict(weights.make_state_dict(cfg, seed, device), strict=True)
    return model.eval()


class fp32_flags:
    """TF32 off for matmuls and cuDNN inside the block; the flags restored."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
