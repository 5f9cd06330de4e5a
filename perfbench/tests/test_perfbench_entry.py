"""The command refuses to run without a card or without the program, and
nothing it loads is JAX or the JAX package."""

import ast
import json
import os
import shutil
import subprocess
import sys

from tiny import ROOT

ARGS = ["--workload", "swinl-1280x1920-b1", "--seed", "2147483653", "--seconds", "1", "--trace", "0"]


def child(cwd, code, env=None):
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2", **(env or {}))
    e.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e, capture_output=True, text=True,
                          timeout=600)


def test_a_run_without_a_card_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "perfbench.run", *ARGS], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=600)
    assert p.returncode == 2 and p.stdout == ""
    assert "needs 1 CUDA card" in p.stderr


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    # past the look for a card, as on the card: the program is what is missing
    code = ("import sys, torch; torch.cuda.is_available = lambda: True; torch.cuda.device_count = lambda: 1; "
            f"from perfbench import run; sys.exit(run.main({ARGS!r}))")
    p = child(str(tmp_path), code)
    assert p.returncode != 0 and p.stdout == ""
    assert "codetr_torch" in p.stderr


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(ROOT, "perfbench", "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, name)).read())
            mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
            mods += [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
            assert not any(m.split(".")[0] in ("codetr_torch", "codetr_tpu", "jax") for m in mods), (name, mods)
    p = child(ROOT, "import sys, json; import perfbench.reference.model, perfbench.reference.pipeline; "
                    "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0].startswith('codetr'))))")
    assert p.returncode == 0 and json.loads(p.stdout) == []


def test_a_run_loads_no_jax():
    """The harness, a whole tiny run on the CPU and the reference: then no
    loaded module's top-level name is JAX's or the JAX package's."""
    code = (
        "import sys, time, json; sys.path.insert(0, 'perfbench/tests'); import tiny; "
        "from perfbench import harness; "
        "r = harness.run_cell(tiny.cell(), 5, 0.3, False, 'cpu', time.perf_counter()); "
        "tops = {m.split('.')[0] for m in sys.modules}; "
        "print(json.dumps([r['correct'], harness.forbidden_modules(), 'codetr_torch' in tops]))"
    )
    p = child(ROOT, code)
    assert p.returncode == 0, p.stderr[-2000:]
    correct, found, program = json.loads(p.stdout.strip().splitlines()[-1])
    assert correct and found == [] and program
