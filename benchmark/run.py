"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The caches of the program's builds stay
inside the checkout, at fixed paths.
"""

import os
import sys

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(ROOT, ".bench_cache", sub)
sys.path[:0] = [BENCH_DIR, ROOT]

from harness import runner  # noqa: E402

if __name__ == "__main__":
    sys.exit(runner.main(sys.argv[1:]))
