"""The benchmark's tests: ``python -m pytest perfbench/tests`` from the
repository's root.  They run on the CPU at tiny sizes; those marked
``gpu`` need a CUDA card and skip without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
