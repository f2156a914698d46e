"""The control of the correctness check, which the benchmark's own runs
never make: one run of a cell whose result line also carries, under
`control`, each compared number of the reference put in the program's
place and judged as the program is: computed one precision lower (TF32
matmuls, the compositor's field table in bfloat16; `control`), with its
steps returning their state unchanged (`unchanged`), with half of the
window's views left out (`half`), and again in float32 (`again`), and
the program's own numbers (`program`). Runs on the card:

    python3 benchmark/control.py --workload <cell> --seed <n> --seconds <s>

The limits of `limits/<cell>.json` were set from these readings."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parents[1])

if __name__ == "__main__":
    import benchmark.run  # noqa: F401  (the cache directories)
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:] + ["--trace", "0"], T_START, control=True))
