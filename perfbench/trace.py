"""``torch.profiler`` traces of a few requests, read back into what the
per-layer metrics need.

``capture(host=...)`` profiles its body and yields a holder whose ``view``
is set on exit: the Chrome trace is written to a temporary file (under
``TMPDIR``), read and deleted.  With ``host=True`` the trace holds the
host's ops and named ranges beside the device's (CPU and CUDA
activities); recording every host op slows the host by ~30% at Swin-L
1280x1920, so the device's busy and idle time is read from a
``host=False`` trace (CUDA activity alone: device operations and the
runtime calls that launched them).  ``TraceView`` ties each device
operation (kernel, memcpy, memset) to the runtime call that launched it by
the profiler's correlation id, and each launch to the named ranges
(``record_function``) around it on the launching thread.  Times are in
microseconds on the trace's clock.  The profiler drops the kernels of a
replayed CUDA graph (the Inferencer's postprocess); ``add_replays`` puts
each replay back as one device operation, timed by CUDA events around it
(``harness.ReplayTimer``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
REQUEST = "request"  # the benchmark's own range around each traced request
GRAPH_LAUNCH = "cudaGraphLaunch"
REPLAY = "CUDA graph replay, timed by CUDA events"


@dataclass
class Op:
    name: str
    ts: float
    dur: float
    launch_ts: Optional[float]  # host time of the launching call
    launch_tid: Optional[object]


@dataclass
class Range:
    name: str
    ts: float
    end: float
    tid: object
    annotation: bool  # a record_function range, not an op


@dataclass
class TraceView:
    ops: List[Op]
    ranges: List[Range]  # user annotations
    host: List[Range] = field(default_factory=list)  # cpu ops and user annotations

    @classmethod
    def from_events(cls, events: Sequence[dict]) -> "TraceView":
        launches: Dict[object, Tuple[float, object]] = {}
        ops_raw, ranges, host = [], [], []
        for e in events:
            cat = e.get("cat")
            if e.get("ph") != "X":
                continue
            if cat in LAUNCH_CATS:
                host.append(Range(e["name"], e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"), False))
                if "correlation" in e.get("args", {}):
                    launches[e["args"]["correlation"]] = (e["ts"], e.get("tid"))
            elif cat in DEVICE_CATS:
                ops_raw.append(e)
            elif cat in ("user_annotation", "cpu_op"):
                r = Range(e["name"], e["ts"], e["ts"] + e.get("dur", 0), e.get("tid"), cat == "user_annotation")
                host.append(r)
                if cat == "user_annotation":
                    ranges.append(r)
        ops = []
        for e in ops_raw:
            ts, tid = launches.get(e.get("args", {}).get("correlation"), (None, None))
            ops.append(Op(e["name"], e["ts"], e.get("dur", 0), ts, tid))
        ops.sort(key=lambda o: o.ts)
        return cls(ops, ranges, host)

    def add_replays(self, durations: Sequence[float]) -> bool:
        """Puts the timed graph replays into the device's timeline: the i-th
        ``cudaGraphLaunch`` call with the i-th duration (µs), as one
        operation launched by that call.  It starts when the call starts or
        when the operations launched before it end, whichever is later (one
        stream runs them in order), or where the first of its own kernels
        that the trace kept starts; those are dropped, the events' time
        covering them.  The events' interval holds any time in which the
        device waits for the graph's launch (``cudaGraphLaunch`` of the
        soft-NMS graph takes milliseconds on the host), which so counts as
        the replay's.  -> False, and the view unchanged, where the calls
        and the durations differ in number."""
        launches = sorted((r for r in self.host if GRAPH_LAUNCH in r.name), key=lambda r: r.ts)
        if len(launches) != len(durations):
            return False
        for r, dur in zip(launches, durations):
            own = [op for op in self.ops if op.launch_ts == r.ts and op.launch_tid == r.tid]
            if own:
                start = min(op.ts for op in own)
            else:
                start = max([r.ts] + [op.ts + op.dur for op in self.ops
                                      if op.launch_ts is not None and op.launch_ts < r.ts])
            self.ops = [op for op in self.ops if not (op.launch_ts == r.ts and op.launch_tid == r.tid)]
            self.ops.append(Op(REPLAY, start, dur, r.ts, r.tid))
        self.ops.sort(key=lambda o: o.ts)
        return True

    def named(self, name: str) -> List[Range]:
        return sorted((r for r in self.ranges if r.name == name), key=lambda r: r.ts)

    def window(self) -> Tuple[float, float]:
        """Start of the first traced request and end of the last; without
        named ranges, the first host call to the end of the last host call
        or device operation."""
        reqs = self.named(REQUEST)
        if reqs:
            return reqs[0].ts, max(r.end for r in reqs)
        if not self.host and not self.ops:
            raise ValueError("the trace is empty")
        starts = [r.ts for r in self.host] or [op.ts for op in self.ops]
        ends = [r.end for r in self.host] + [op.ts + op.dur for op in self.ops]
        return min(starts), max(ends)

    def launched_in(self, name: str) -> List[Op]:
        """Device operations whose launch lies inside a range ``name`` on
        the launching thread."""
        spans = self.named(name)
        starts = [r.ts for r in spans]
        out = []
        for op in self.ops:
            if op.launch_ts is None:
                continue
            i = bisect.bisect_right(starts, op.launch_ts) - 1
            if i >= 0 and spans[i].ts <= op.launch_ts <= spans[i].end and spans[i].tid == op.launch_tid:
                out.append(op)
        return out

    def busy(self) -> Tuple[float, List[Tuple[float, float]]]:
        """(µs in which some device operation ran inside the window, the
        idle gaps (start, end) inside it)."""
        lo, hi = self.window()
        busy, gaps, cur = 0.0, [], lo
        for op in self.ops:
            s, e = max(op.ts, lo), min(op.ts + op.dur, hi)
            if e <= s:
                continue
            if s > cur:
                gaps.append((cur, s))
            if e > cur:
                busy += e - max(s, cur)
                cur = e
        if hi > cur:
            gaps.append((cur, hi))
        return busy, gaps

    def host_at(self, t: float) -> str:
        """The innermost named range and host op (or runtime call) running
        at ``t`` on the thread of the traced requests."""
        reqs = self.named(REQUEST)
        tids = [r.tid for r in self.host]
        tid = reqs[0].tid if reqs else max(set(tids), key=tids.count) if tids else None
        covering = [r for r in self.host if r.tid == tid and r.ts <= t <= r.end]
        ann = [r for r in covering if r.annotation and r.name != REQUEST]
        ops = [r for r in covering if not r.annotation]
        parts = [min(ann, key=lambda r: r.end - r.ts).name] if ann else []
        if ops:
            parts.append(min(ops, key=lambda r: r.end - r.ts).name)
        return " > ".join(parts) or "host outside any op"


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its argument list, at most ``limit`` chars."""
    name = re.sub(r"\(.*$", "", name.replace("(anonymous namespace)", "anon")).strip()
    return name if len(name) <= limit else name[:limit - 3] + "..."


def breakdown(view: TraceView, host_view: Optional[TraceView] = None, top: int = 10) -> dict:
    """The device operations that took most time (summed by name) in
    ``view``, and the longest idle gaps of ``host_view`` (default ``view``)
    with what the host was doing, in seconds."""
    lo, hi = view.window()
    by_name: Dict[str, float] = {}
    for op in view.ops:
        if lo <= op.ts <= hi:
            key = short_name(op.name)
            by_name[key] = by_name.get(key, 0.0) + op.dur
    host_view = host_view or view
    _, gaps = host_view.busy()
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {
        "device_ops": [[n, d / 1e6] for n, d in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[host_view.host_at((a + b) / 2), (b - a) / 1e6] for a, b in longest],
    }


class Capture:
    view: Optional[TraceView] = None


@contextlib.contextmanager
def capture(host: bool = True):
    """Profile the body (CUDA activity, and with ``host`` the CPU's); the
    yielded holder's ``view`` is the trace, read once the body is done."""
    from torch.profiler import ProfilerActivity, profile

    import torch

    activities = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    if not activities:
        activities = [ProfilerActivity.CPU]
    holder = Capture()
    with profile(activities=activities) as prof:
        yield holder
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    holder.view = TraceView.from_events(events)
