"""The benchmark's CPU tests: the harness's pieces at tiny widths, with an
explicit CPU device. Tests that need a card are marked `cuda` and skip
inside the test when there is none."""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for path in (os.path.dirname(BENCH_DIR), BENCH_DIR):
    if path not in sys.path:
        sys.path.insert(0, path)
