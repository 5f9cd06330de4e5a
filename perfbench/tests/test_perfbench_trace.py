"""The trace reader on a small synthetic Chrome trace with known answers."""

import pytest

from perfbench.trace import TraceView, breakdown


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def synthetic():
    # host (tid 1): request [0, 100] holds preprocess [0, 20] and forward [20, 90];
    # launches at 5 (memcpy), 25 and 30 (kernels), 95 (outside both ranges)
    # device (tid 7): memcpy [10, 20], k1 [30, 50], k2 [45, 70], k3 [96, 99]
    return [
        ev("user_annotation", "request", 0, 100),
        ev("user_annotation", "preprocess", 0, 20),
        ev("user_annotation", "forward", 20, 70),
        ev("cpu_op", "aten::copy_", 4, 3),
        ev("cpu_op", "aten::mm", 24, 10),
        ev("cpu_op", "aten::add", 72, 15),
        ev("cuda_runtime", "cudaMemcpyAsync", 5, 1, corr=1),
        ev("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=2),
        ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=3),
        ev("cuda_runtime", "cudaLaunchKernel", 95, 1, corr=4),
        ev("gpu_memcpy", "Memcpy HtoD", 10, 10, tid=7, corr=1),
        ev("kernel", "void msda_tile_fwd_kernel<bf16>(int)", 30, 20, tid=7, corr=2),
        ev("kernel", "gemm_kernel", 45, 25, tid=7, corr=3),
        ev("kernel", "nms_kernel", 96, 3, tid=7, corr=4),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1},
    ]


def test_ranges_hold_the_operations_their_host_calls_launched():
    view = TraceView.from_events(synthetic())
    assert [op.name for op in view.launched_in("preprocess")] == ["Memcpy HtoD"]
    assert sorted(op.dur for op in view.launched_in("forward")) == [20, 25]
    assert view.launched_in("postprocess") == []


def test_short_names_keep_anonymous_namespaces():
    from perfbench.trace import short_name

    assert short_name("void at::native::(anonymous namespace)::k<float>(int, float*)") == \
        "void at::native::anon::k<float>"
    assert len(short_name("x" * 300)) == 96


def test_busy_and_idle():
    view = TraceView.from_events(synthetic())
    busy, gaps = view.busy()
    # union of [10, 20], [30, 70], [96, 99] in the window [0, 100]
    assert busy == pytest.approx(10 + 40 + 3)
    assert gaps == [(0, 10), (20, 30), (70, 96), (99, 100)]
    assert view.window() == (0, 100)


def test_breakdown_names_device_ops_and_what_the_host_did_in_the_gaps():
    b = breakdown(TraceView.from_events(synthetic()))
    assert b["device_ops"][0] == ["gemm_kernel", 25e-6]
    assert b["device_ops"][1] == ["void msda_tile_fwd_kernel<bf16>", 20e-6]
    longest = b["idle_gaps"][0]
    assert longest[1] == pytest.approx(26e-6) and longest[0] == "forward > aten::add"
    assert len(b["idle_gaps"]) == 4


def test_idle_share_reader():
    from perfbench import spec
    from tiny import ROOT

    class Run:
        device_trace = TraceView.from_events(synthetic())

    assert spec.reader(ROOT, "device.idle_share")(Run) == pytest.approx(47.0)


def test_a_trace_without_host_ranges_spans_its_host_calls_and_device_ops():
    """A device-only trace: the runtime calls and the device operations."""
    events = [e for e in synthetic() if e["cat"] not in ("user_annotation", "cpu_op")]
    view = TraceView.from_events(events)
    assert view.window() == (5, 99)
    busy, gaps = view.busy()
    assert busy == pytest.approx(53) and gaps[0] == (5, 10)
    assert view.host_at(83) == "host outside any op" and view.host_at(95.5) == "cudaLaunchKernel"
    b = breakdown(view, TraceView.from_events(synthetic()))
    assert b["idle_gaps"][0][0] == "forward > aten::add"


def with_replays(kept=()):
    """``synthetic()`` plus, in a postprocess range [100, 130], a memcpy
    launched at 101 and two graph launches at 110 and 120 whose kernels the
    profiler dropped, but for ``kept`` (names of the second one's kernels)."""
    events = synthetic() + [
        ev("user_annotation", "postprocess", 100, 30),
        ev("cuda_runtime", "cudaMemcpyAsync", 101, 1, corr=5),
        ev("gpu_memcpy", "Memcpy DtoD", 102, 4, tid=7, corr=5),
        ev("cuda_runtime", "cudaGraphLaunch", 110, 2, corr=6),
        ev("cuda_runtime", "cudaGraphLaunch", 120, 2, corr=7),
    ]
    return events + [ev("kernel", k, 200 + 5 * i, 3, tid=7, corr=7) for i, k in enumerate(kept)]


def test_replays_timed_by_events_are_put_into_the_timeline():
    from perfbench.trace import REPLAY

    view = TraceView.from_events(with_replays())
    assert view.add_replays([8.0, 6.0])
    replays = [op for op in view.ops if op.name == REPLAY]
    # each starts at its launch: the memcpy before the first ended at 106, the first at 118
    assert [(op.ts, op.dur) for op in replays] == [(110, 8.0), (120, 6.0)]
    assert sum(op.dur for op in view.launched_in("postprocess")) == 4 + 8 + 6
    view = TraceView.from_events(with_replays())
    assert not view.add_replays([8.0]) and not any(op.name == REPLAY for op in view.ops)


def test_a_replay_starts_after_the_work_launched_before_it():
    from perfbench.trace import REPLAY

    events = with_replays() + [ev("cuda_runtime", "cudaLaunchKernel", 108, 1, corr=8),
                               ev("kernel", "slow_kernel", 109, 20, tid=7, corr=8)]
    view = TraceView.from_events(events)
    assert view.add_replays([8.0, 6.0])
    # the first replay waits for slow_kernel (ends at 129), the second for the first (137)
    assert [(op.ts, op.dur) for op in view.ops if op.name == REPLAY] == [(129, 8.0), (137, 6.0)]


def test_kernels_the_trace_kept_of_a_replay_give_way_to_its_events():
    from perfbench.trace import REPLAY

    view = TraceView.from_events(with_replays(kept=("nms_a", "nms_b")))
    assert view.add_replays([8.0, 6.0])
    assert not any(op.name in ("nms_a", "nms_b") for op in view.ops)
    assert [(op.ts, op.dur) for op in view.ops if op.name == REPLAY] == [(110, 8.0), (200, 6.0)]
