#!/usr/bin/env python3
"""The benchmark's command: one run of one cell of BENCHMARK.json.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cell's CUDA cards;
harness.py says what a run does and prints.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, ROOT)
# build and kernel caches at fixed paths inside the checkout, set before torch loads
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ.setdefault(_var, os.path.join(ROOT, ".bench_cache", _sub))

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
