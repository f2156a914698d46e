"""Runs one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; see benchmark/README.md and harness.py."""

import time

T_START = time.perf_counter()   # the set-up time counts from here

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# import the benchmark as a package from the checkout's root, never its
# modules by bare name from this directory
sys.path[0] = str(ROOT)
# every build and kernel cache in fixed directories inside the checkout
CACHE = ROOT / "benchmark" / "cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
