"""The benchmark's command:

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout that holds the program (``codetr_torch``)
beside ``perfbench/``.  It needs as many CUDA cards as the cell asks for
and exits with code 2, printing no result, without them; it never falls
back to the CPU.  The last line of standard output is the result (one JSON
object); the compared numbers and their limits are the last lines of
standard error.  It exits with code 3, printing no result, if a module of
the JAX package or of JAX is loaded once the window has closed.

Caches: Triton's and Inductor's under ``perfbench/.cache/`` (fixed paths,
git-ignored); the program's own kernel build directory is
``codetr_torch/_build/``, inside the checkout too.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here, before any heavy import

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "perfbench", ".cache")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Run one cell of the benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(CACHE, "inductor")
    from perfbench import spec

    cell = spec.load(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    import codetr_torch  # noqa: F401  (the program under test: without it the run ends here)

    from perfbench import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules loaded that the run must not load: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {result['correct']} failed {result['failed']} of {result['attempted']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
