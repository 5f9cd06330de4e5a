"""The port's benchmark matrix, timers, profiling helpers and CLIs.

``codetr_torch.bench.MATRIX`` must be the JAX ``bench.py``'s five
configurations; ``runtime.aot.benchmark`` and ``utils.profiling.
latency_report`` return the JAX functions' keys; the eager timer runs on
the CPU and the graph timer refuses it; ``measure_config`` exports and
times the tiny model on the CPU; both CLIs parse, and ``python -m
codetr_torch.export_aot`` writes the program, its meta, the predictions
and the drawing.  The device numbers themselves come only from the card
(``chip_smoke.py``).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jax_bench
from codetr_tpu.runtime.aot import benchmark as jax_benchmark
from codetr_tpu.utils.profiling import latency_report as jax_latency_report
from codetr_torch import bench, build_codetr, tiny_test_config
from codetr_torch import export_aot
from codetr_torch.runtime import aot
from codetr_torch.utils import profiling
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = 96


@pytest.fixture(scope="module")
def tiny():
    model = build_codetr(tiny_test_config(), device="cpu", seed=1)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, HW, HW, 3)).astype(np.float32))
    return model, (x, torch.zeros(1, HW, HW))


@pytest.fixture(scope="module")
def program(tiny):
    return aot.compile_forward(tiny[0], height=HW, width=HW, batch_size=2)


def test_matrix_equals_the_jax_bench_matrix():
    keys = ("family", "width", "height", "dtype_str", "batch_size")
    assert [tuple(c[k] for k in keys) for c in bench.MATRIX] == \
        [tuple(c[k] for k in keys) for c in jax_bench.MATRIX]
    assert bench.TRT_BASELINE_MS == jax_bench.TRT_BASELINE_MS


@pytest.mark.parametrize("cli", [bench, export_aot], ids=["bench", "export_aot"])
def test_cli_help_exits_0(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.parse_args(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


def test_cli_flags_parse():
    args = bench.parse_args(["--single", "--device", "cpu", "--width", "608", "--height", "608"])
    assert (args.single, args.device, args.width, args.height, args.dtype) == (True, "cpu", 608, 608, "bfloat16")
    args = export_aot.parse_args(["--config", "tiny", "--device", "cpu", "--fuse-preprocess",
                                  "--skip-benchmark", "--output", "out"])
    assert (args.config, args.device, args.fuse_preprocess, args.skip_benchmark) == ("tiny", "cpu", True, True)
    assert export_aot.parse_args([]).device == "cuda"


def test_benchmark_and_latency_report_return_the_jax_keys(tiny):
    model, args = tiny
    jfn = jax.jit(lambda a: (a * 2.0, a.sum()))
    jargs = (jnp.ones((8, 8), jnp.float32),)
    stats = aot.benchmark(model, args, iterations=4, warmup=1, blocks=2, graph=False)
    want = jax_benchmark(jfn, jargs, iterations=4, warmup=1, blocks=2)
    assert set(want) <= set(stats)
    assert stats["iterations"] == 4 and len(stats["blocks_ms"]) == 2 and stats["device"] == "cpu"
    assert all(stats[k] > 0 for k in ("device_ms_per_iter", "p50_ms", "p95_ms", "min_ms", "host_e2e_ms"))
    report = profiling.latency_report(model, args, iterations=2)
    assert set(jax_latency_report(jfn, jargs, iterations=2)) <= set(report)
    assert report["device"] == "cpu" and report["device_compute_ms"] > 0


def test_loop_timer_on_the_cpu(tiny):
    model, args = tiny
    run = aot.make_loop_timer(model, args, graph=False, warmup=1)
    assert run(2) > 0
    with pytest.raises(ValueError, match="card"):
        aot.make_loop_timer(model, args, graph=True)


def test_measure_config_on_the_cpu(program):
    """The matrix's measurement path on an exported tiny program at batch 2:
    ms per image, named as a CPU latency, with no kernel launched."""
    r = bench.measure_config(family="tiny", width=HW, height=HW, dtype_str="float32", batch_size=2,
                             iterations=2, blocks=2, device="cpu", program=program, note="tiny")
    for key in ("metric", "value", "unit", "vs_baseline", "measurement_mode", "p50_ms", "p95_ms",
                "min_ms", "rounds", "note", "eager_ms", "device"):
        assert key in r, key
    assert r["value"] > 0 and r["device"] == "cpu" and "CPU" in r["metric"] and "bs2" in r["metric"]
    assert r["vs_baseline"] is None and r["msda_launches_per_call"] == 0


def test_save_graph_and_cost_analysis(tiny, program, tmp_path):
    model, args = tiny
    path = profiling.save_graph(program[0], str(tmp_path / "graph.txt"))
    text = open(path).read()
    assert text.count("codetr.msda_packed.default") >= 2 and "codetr.msda_reference.default" in text
    cost = profiling.cost_analysis(model, args)
    assert cost["bytes"] is None
    ops = cost["flops_by_op"]
    # 2 encoder layers: the (1, K, 4 heads, 8) value, every key a query, 5
    # levels x 2 points a tap; 2 decoder layers of 12 queries
    K = sum((-(-HW // s)) ** 2 for s in (4, 8, 16, 32, 64))
    assert ops["codetr.msda_packed"] == 2 * K * 4 * 10 * 4 * 8 * 2
    assert ops["codetr.msda_reference"] == 2 * 12 * 4 * 10 * 4 * 8 * 2
    assert cost["flops"] > sum(ops[k] for k in ("codetr.msda_packed", "codetr.msda_reference"))


def test_trace_and_annotate_write_a_chrome_trace(tiny, tmp_path):
    model, args = tiny
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("tiny forward"), torch.no_grad():
            model(*args)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "tiny forward" for e in events)
    assert any("codetr::msda_packed" in e.key for e in prof.key_averages())


def test_export_aot_cli_writes_its_outputs(tmp_path):
    out = tmp_path / "export"
    # two threads: beside the suite's workers, a subprocess with one thread
    # per core took 13x its time alone (24 s)
    proc = subprocess.run(
        [sys.executable, "-m", "codetr_torch.export_aot", "--config", "tiny", "--device", "cpu",
         "--image", "assets/demo_synthetic.jpg", "--skip-benchmark", "--output", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "reload drift vs the in-process program: 0.00e+00" in proc.stdout, proc.stdout
    assert sorted(os.listdir(out)) == ["codetr.codetr.pt2", "codetr.codetr.pt2.meta.json",
                                       "predictions.json", "vis.jpg"]
    meta = json.loads((out / "codetr.codetr.pt2.meta.json").read_text())
    assert (meta["magic"], meta["config"], meta["height"], meta["width"]) == (aot.MAGIC, "tiny", 768, 1152)
    assert meta["msda_ops"] == {"codetr.msda_packed.default": 2, "codetr.msda_reference.default": 2}
    preds = json.loads((out / "predictions.json").read_text())
    assert len(preds) == 1 and set(preds[0]) == {"labels", "scores", "bboxes"}


def test_export_aot_reads_an_npy_image(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (30, 40, 3), np.uint8)
    np.save(tmp_path / "img.npy", img)
    np.testing.assert_array_equal(export_aot.read_image(str(tmp_path / "img.npy")), img)
    with pytest.raises(ValueError, match="uint8"):
        np.save(tmp_path / "bad.npy", img.astype(np.float32))
        export_aot.read_image(str(tmp_path / "bad.npy"))
