"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout; see ``benchmark/harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "build")
# every cache the program could write stays in the checkout, at fixed paths
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(BUILD, "triton_cache"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(BUILD, "torch_extensions"))
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
